"""The port's own native bindings (``_native.py``, built from the repository's
``native/src``: ``ply_codec.cpp``, ``graph_ops.cpp``, ``ball_pivot.cpp`` and
``grid_knn.cpp``) against the JAX package's ``native.py`` on the CPU, and the
two paths that use them: ``"tangent"`` orientation as the JAX package runs it
by default (native library on) and mesh mode ``"surface"``.

Tolerances:
* the graph bindings on one shared KNN graph and one set of radii,
  ``grid_knn`` and ``dbscan_labels`` on the same seeded inputs: bit-equal,
  and ``ply_write`` / ``stl_write``: byte-identical files (both libraries
  compile the same sources with the same flags on this host); the JAX
  tests' own contracts besides — ``grid_knn`` within 1e-4 of a kd-tree with
  the same indices, DBSCAN's two blobs;
* ``"tangent"`` end to end: each package builds its own exact KNN graph,
  which may order tied neighbours differently, so the signs agree on
  ≥ 99.9% of points, and every component points outward;
* mode ``"surface"``: face counts within 1% of the JAX package's, with the
  properties of tests/test_ball_pivot_validation.py — a watertight outward
  sphere, the torus's topology and an open cylinder's rims kept open;
* without the library: the scipy MST, and for ``"surface"`` the Poisson
  fallback trimmed at 25%, within 1% of the JAX package's fallback faces.
"""

import os
from collections import Counter

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from structured_light_for_3d_model_replication_tpu import native as jnative
from structured_light_for_3d_model_replication_tpu.io import ply as jply
from structured_light_for_3d_model_replication_tpu.models import (
    meshing as jmeshing,
)
from structured_light_for_3d_model_replication_tpu_torch import _native
from structured_light_for_3d_model_replication_tpu_torch.io import ply
from structured_light_for_3d_model_replication_tpu_torch.io.stl import read_stl
from structured_light_for_3d_model_replication_tpu_torch.models import (
    meshing,
)


@pytest.fixture(autouse=True, scope="module")
def _share_cores_with_workers():
    """This module's PyTorch ops take the worker's share of the cores
    (xdist workers share the host)."""
    n = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, n // workers))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _libraries():
    if not jnative.available():
        pytest.fail("the JAX package's native library did not build")
    assert _native.available(), "the port's native library did not build"


CENTERS = np.array([[0.0, 10.0, 500.0], [200.0, 210.0, 700.0]])


def _spheres(n, seed, r=25.0, noise=0.0):
    """n samples split over two spheres of radius r far apart, with their
    true outward normals."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    c = CENTERS[np.arange(n) % 2]
    pts = c + u * r + rng.normal(0, noise, (n, 3))
    return pts.astype(np.float32), u.astype(np.float32)


def _graph(pts, k):
    """One shared (n, k) KNN table with a few invalid slots."""
    _, idx = cKDTree(pts).query(pts, k=k)
    ok = np.ones(idx.shape, bool)
    ok[::7, -1] = False
    return idx.astype(np.int32), ok


def _radii(pts):
    d, _ = cKDTree(pts).query(pts, k=2)
    avg = float(d[:, 1].mean())
    return [avg * m for m in (1.0, 2.0, 4.0)]


def test_library_is_the_ports_own():
    """Built from the repository's sources into the git-ignored
    ``build/native/``, never into ``native/``."""
    path = _native.library_path()
    assert path.exists() and path.parent.name == "native"
    assert path.parent.parent.name == "build"
    assert [s.name for s in _native._SOURCES] == [
        "ply_codec.cpp", "graph_ops.cpp", "ball_pivot.cpp", "grid_knn.cpp"]


def test_mst_orient_normals_bit_equal_to_jax():
    pts, nrm = _spheres(2000, 1, noise=0.05)
    flipped = np.where((np.arange(2000) % 3 == 0)[:, None], -nrm, nrm)
    idx, ok = _graph(pts, 12)
    for seed_dir in ((0.0, 0.0, 0.0), (0.3, -1.0, 0.2)):
        got, n_got = _native.mst_orient_normals(pts, flipped, idx, ok,
                                                seed_dir=seed_dir)
        ref, n_ref = jnative.mst_orient_normals(pts, flipped, idx, ok,
                                                seed_dir=seed_dir)
        assert n_got == n_ref == 2
        np.testing.assert_array_equal(got, ref)
    assert np.all(np.abs(got) == np.abs(flipped))


def test_connected_components_bit_equal_to_jax():
    pts, _ = _spheres(1500, 2)
    idx, ok = _graph(pts, 8)
    labels, count = _native.connected_components(idx, ok)
    ref, ref_count = jnative.connected_components(idx, ok)
    assert count == ref_count == 2
    np.testing.assert_array_equal(labels, ref)


def test_ball_pivot_bit_equal_to_jax():
    rng = np.random.default_rng(3)
    u = rng.normal(size=(2500, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts, nrm = (u * 40.0).astype(np.float32), u.astype(np.float32)
    radii = _radii(pts)
    for holes in (12, 0):
        got = _native.ball_pivot(pts, nrm, radii, max_hole_edges=holes)
        ref = jnative.ball_pivot(pts, nrm, radii, max_hole_edges=holes)
        assert got.dtype == np.int32 and len(got) > 4000
        np.testing.assert_array_equal(got, ref)


def test_bindings_validate_their_inputs():
    pts, nrm = _spheres(50, 4)
    idx, ok = _graph(pts, 4)
    bad = idx.copy()
    bad[3, 1] = 50
    with pytest.raises(ValueError, match="out of range"):
        _native.connected_components(bad, ok)
    with pytest.raises(ValueError, match="must be"):
        _native.mst_orient_normals(pts[:10], nrm, idx, ok)
    with pytest.raises(ValueError, match="must be"):
        _native.ball_pivot(pts, nrm[:10], [1.0])


@pytest.mark.parametrize("case", ["self", "self kept", "queries",
                                  "k above n"])
def test_grid_knn_bit_equal_to_jax(case):
    rng = np.random.default_rng(12)
    pts = rng.normal(size=(1500, 3)).astype(np.float32)
    kw = {"self kept": {"exclude_self": False},
          "queries": {"queries": rng.normal(size=(300, 3)).astype(
              np.float32)}}.get(case, {})
    if case == "k above n":
        pts = pts[:9]
    k = 12 if case == "k above n" else 8
    d2, idx = _native.grid_knn(pts, k, **kw)
    ref_d2, ref_idx = jnative.grid_knn(pts, k, **kw)
    assert d2.dtype == np.float32 and idx.dtype == np.int32
    np.testing.assert_array_equal(d2, ref_d2)
    np.testing.assert_array_equal(idx, ref_idx)
    if case == "k above n":
        assert (idx[:, 8:] == -1).all() and (idx[:, :8] >= 0).all()


@pytest.mark.parametrize("separate", [False, True])
def test_grid_knn_matches_kdtree(separate):
    """tests/test_native.py's contract: sqrt(d2) within 1e-4 of cKDTree and
    the same indices, self excluded from a self query."""
    rng = np.random.default_rng(13)
    pts = rng.normal(size=(1200, 3)).astype(np.float32)
    if separate:
        q = rng.normal(size=(100, 3)).astype(np.float32)
        d2, idx = _native.grid_knn(pts, 4, queries=q)
        ref_d, ref_i = cKDTree(pts).query(q, k=4)
    else:
        d2, idx = _native.grid_knn(pts, 6)
        ref_d, ref_i = cKDTree(pts).query(pts, k=7)
        ref_d, ref_i = ref_d[:, 1:], ref_i[:, 1:]
    np.testing.assert_allclose(np.sqrt(d2), ref_d, atol=1e-4)
    np.testing.assert_array_equal(idx, ref_i)


def test_dbscan_labels_bit_equal_to_jax():
    """Two blobs and scattered noise through each package's DBSCAN
    labelling on one KNN graph: equal labels, and tests/test_native.py's
    contract — two clusters, one a blob."""
    rng = np.random.default_rng(14)
    pts = np.vstack([rng.normal(size=(300, 3)),
                     rng.normal(size=(300, 3)) + 30,
                     rng.uniform(-60, 90, (40, 3))]).astype(np.float32)
    d2, idx = _native.grid_knn(pts, 8)
    ok = (d2 < 9.0) & (idx >= 0)
    core = ok.sum(1) >= 4
    labels, count = _native.dbscan_labels(idx, ok, core)
    ref, ref_count = jnative.dbscan_labels(idx, ok, core)
    np.testing.assert_array_equal(labels, ref)
    assert count == ref_count == 2
    assert len(set(labels[:300]) - {-1}) == 1
    assert len(set(labels[300:600]) - {-1}) == 1
    assert set(labels[:300]) != set(labels[300:600])


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
@pytest.mark.parametrize("fields", ["points", "colors", "normals", "all"])
def test_ply_write_byte_equal_to_jax(binary, fields, tmp_path):
    rng = np.random.default_rng(15)
    pts = rng.normal(size=(500, 3)).astype(np.float32) * 100
    col = rng.integers(0, 256, (500, 3)).astype(np.uint8)
    nrm = rng.normal(size=(500, 3)).astype(np.float32)
    kw = {"colors": col if fields in ("colors", "all") else None,
          "normals": nrm if fields in ("normals", "all") else None}
    got, ref = tmp_path / "port.ply", tmp_path / "jax.ply"
    _native.ply_write(str(got), pts, binary=binary, **kw)
    jnative.ply_write(str(ref), pts, binary=binary, **kw)
    assert got.read_bytes() == ref.read_bytes()
    cloud = ply.read_ply(str(got))
    if binary:
        np.testing.assert_array_equal(cloud.points, pts)
        if kw["normals"] is not None:
            np.testing.assert_array_equal(cloud.normals, nrm)
    else:
        np.testing.assert_allclose(cloud.points, pts, atol=1e-4)
    if kw["colors"] is not None:
        np.testing.assert_array_equal(cloud.colors, col)


def test_stl_write_byte_equal_to_jax(tmp_path):
    """A sphere's ball-pivot mesh through both writers: the same bytes,
    read back by the port's reader to the same triangles."""
    rng = np.random.default_rng(16)
    u = rng.normal(size=(1500, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    verts, nrm = (u * 40.0).astype(np.float32), u.astype(np.float32)
    faces = _native.ball_pivot(verts, nrm, _radii(verts))
    got, ref = tmp_path / "port.stl", tmp_path / "jax.stl"
    _native.stl_write(str(got), verts, faces)
    jnative.stl_write(str(ref), verts, faces)
    data = got.read_bytes()
    assert data == ref.read_bytes()
    assert len(data) == 84 + 50 * len(faces)
    mesh = read_stl(str(got))
    np.testing.assert_array_equal(mesh.vertices[mesh.faces], verts[faces])


def test_new_bindings_raise_without_the_library(monkeypatch, tmp_path):
    """No silent stand-in: without the library each binding raises."""
    monkeypatch.setattr(_native, "_load", lambda: None)
    pts = np.zeros((4, 3), np.float32)
    idx = np.zeros((4, 2), np.int32)
    calls = (lambda: _native.ply_write(str(tmp_path / "a.ply"), pts),
             lambda: _native.stl_write(str(tmp_path / "a.stl"), pts,
                                       np.zeros((1, 3), np.int32)),
             lambda: _native.dbscan_labels(idx, idx > 0, np.ones(4, bool)),
             lambda: _native.grid_knn(pts, 2))
    for call in calls:
        with pytest.raises(RuntimeError, match="native layer unavailable"):
            call()
    assert not (tmp_path / "a.ply").exists()


def test_new_bindings_validate_their_inputs(tmp_path):
    pts = np.zeros((4, 3), np.float32)
    with pytest.raises(ValueError, match="colors"):
        _native.ply_write(str(tmp_path / "a.ply"), pts,
                          colors=np.zeros((3, 3), np.uint8))
    with pytest.raises(ValueError, match="out of range"):
        _native.stl_write(str(tmp_path / "a.stl"), pts,
                          np.array([[0, 1, 4]], np.int32))
    with pytest.raises(ValueError, match="core"):
        _native.dbscan_labels(np.zeros((4, 2), np.int32),
                              np.ones((4, 2), bool), np.ones(3, bool))
    with pytest.raises(ValueError, match="queries"):
        _native.grid_knn(pts, 2, queries=np.zeros((2, 2), np.float32))


def test_tangent_orientation_matches_jax_default():
    """Both packages' default ``"tangent"``: the native Prim MST and the
    majority radial vote per component (the JAX package's native library
    left on)."""
    pts, nrm = _spheres(3000, 5, noise=0.05)
    flipped = np.where((np.arange(3000) % 4 == 0)[:, None], -nrm, nrm)
    ref = np.asarray(jmeshing.ensure_oriented_normals(
        jply.PointCloud(points=pts, normals=flipped.copy()), "tangent"))
    got = meshing.ensure_oriented_normals(
        ply.PointCloud(points=pts, normals=flipped.copy()), "tangent",
        device="cpu")
    assert np.all(np.abs(got) == np.abs(flipped))
    assert ((got * ref).sum(1) > 0).mean() >= 0.999
    out = (got * (pts - CENTERS[np.arange(3000) % 2])).sum(1) > 0
    assert out.mean() >= 0.999


def test_tangent_takes_scipy_without_the_library(monkeypatch):
    """With ``available()`` false the port takes the scipy MST (the native
    calls are never reached) and still orients every sphere outward."""
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        orientation,
    )

    def refuse(*a, **k):
        raise AssertionError("the native MST was called")

    monkeypatch.setattr(_native, "available", lambda: False)
    monkeypatch.setattr(_native, "mst_orient_normals", refuse)
    pts, nrm = _spheres(2000, 6, noise=0.05)
    flipped = np.where((np.arange(2000) % 4 == 0)[:, None], -nrm, nrm)
    got = orientation.orient_normals_consistent_tangent_plane(
        pts, flipped, k=30, device="cpu")
    out = (got * (pts - CENTERS[np.arange(2000) % 2])).sum(1) > 0
    assert out.mean() >= 0.999


def _metrics(pts, tris, outward_ref=None):
    edges = Counter()
    for t in tris:
        for a, b in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
            edges[(min(a, b), max(a, b))] += 1
    counts = np.array(list(edges.values()))
    m = {"faces": len(tris), "verts_used": len(np.unique(tris)),
         "boundary_edges": int((counts == 1).sum()),
         "nonmanifold_edges": int((counts > 2).sum())}
    if outward_ref is not None:
        a, b, c = pts[tris[:, 0]], pts[tris[:, 1]], pts[tris[:, 2]]
        fn = np.cross(b - a, c - a)
        m["outward_frac"] = float((np.einsum(
            "ij,ij->i", fn, outward_ref((a + b + c) / 3)) > 0).mean())
    return m


def _surface_pair(pts, nrm, orientation="radial"):
    ref = jmeshing.mesh_from_cloud(
        jply.PointCloud(points=pts.copy(), normals=nrm.copy()),
        mode="surface", orientation_mode=orientation)
    got = meshing.mesh_from_cloud(
        ply.PointCloud(points=pts.copy(), normals=nrm.copy()),
        mode="surface", orientation_mode=orientation, device="cpu")
    assert abs(len(got.faces) - len(ref.faces)) <= 0.01 * len(ref.faces)
    np.testing.assert_array_equal(got.vertices, pts)
    return got


def test_surface_mode_sphere_matches_jax():
    rng = np.random.default_rng(7)
    u = rng.normal(size=(4000, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts, nrm = (u * 50.0).astype(np.float32), u.astype(np.float32)
    mesh = _surface_pair(pts, nrm)
    m = _metrics(pts, mesh.faces, outward_ref=lambda c: c / np.linalg.norm(
        c, axis=1, keepdims=True))
    assert m["faces"] > 1.6 * len(pts)
    assert m["nonmanifold_edges"] == 0
    assert m["boundary_edges"] < 0.01 * m["faces"]
    assert m["outward_frac"] > 0.99
    assert m["verts_used"] > 0.95 * len(pts)


def test_surface_mode_torus_matches_jax():
    rng = np.random.default_rng(8)
    a = rng.uniform(0, 2 * np.pi, 6000)
    b = rng.uniform(0, 2 * np.pi, 6000)
    pts = np.stack([(50 + 18 * np.cos(b)) * np.cos(a),
                    (50 + 18 * np.cos(b)) * np.sin(a),
                    18 * np.sin(b)], 1).astype(np.float32)
    nrm = np.stack([np.cos(b) * np.cos(a), np.cos(b) * np.sin(a),
                    np.sin(b)], 1).astype(np.float32)
    mesh = _surface_pair(pts, nrm, orientation="tangent")

    def outward(c):
        ax = c.copy()
        ax[:, 2] = 0.0
        ax /= np.maximum(np.linalg.norm(ax, axis=1, keepdims=True), 1e-9)
        d = c - ax * 50.0
        return d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)

    m = _metrics(pts, mesh.faces, outward_ref=outward)
    assert m["faces"] > 1.6 * len(pts)
    assert m["nonmanifold_edges"] == 0
    assert m["boundary_edges"] < 0.01 * m["faces"]
    assert m["outward_frac"] > 0.98


def test_surface_mode_keeps_cylinder_rims_open():
    rng = np.random.default_rng(9)
    a = rng.uniform(0, 2 * np.pi, 4000)
    z = rng.uniform(-60.0, 60.0, 4000)
    pts = np.stack([40 * np.cos(a), 40 * np.sin(a), z], 1).astype(np.float32)
    nrm = np.stack([np.cos(a), np.sin(a), np.zeros(4000)], 1).astype(
        np.float32)
    mesh = _surface_pair(pts, nrm)
    m = _metrics(pts, mesh.faces)
    assert m["faces"] > 1.4 * len(pts)
    assert m["nonmanifold_edges"] == 0
    assert m["boundary_edges"] > 50


def test_surface_radii_follow_the_multipliers():
    pts, _ = _spheres(1000, 10)
    d, _ = cKDTree(pts).query(pts, k=2)
    radii = meshing.ball_pivot_radii(torch.from_numpy(pts), "1,3")
    # float32 distances and mean against scipy's float64.
    np.testing.assert_allclose(radii, [d[:, 1].mean(), 3 * d[:, 1].mean()],
                               rtol=1e-4)
    assert meshing.ball_pivot_radii(torch.from_numpy(pts), "") == \
        meshing.ball_pivot_radii(torch.from_numpy(pts), "1,2,4")


def test_surface_mode_falls_back_to_trimmed_poisson(monkeypatch, caplog):
    """Without the library both packages mesh ``"surface"`` by the Poisson
    solve with at least a 25% trim, and warn."""
    pts, nrm = _spheres(3000, 11)
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(_native, "available", lambda: False)
    ref = jmeshing.mesh_from_cloud(
        jply.PointCloud(points=pts.copy(), normals=nrm.copy()),
        mode="surface", depth=6)
    with caplog.at_level("WARNING"):
        got = meshing.mesh_from_cloud(
            ply.PointCloud(points=pts.copy(), normals=nrm.copy()),
            mode="surface", depth=6, device="cpu")
    assert "Poisson surface fallback" in caplog.text
    trimmed = meshing.mesh_from_cloud(
        ply.PointCloud(points=pts.copy(), normals=nrm.copy()), depth=6,
        quantile_trim=0.25, device="cpu")
    assert abs(len(got.faces) - len(ref.faces)) <= 0.01 * len(ref.faces)
    np.testing.assert_array_equal(got.faces, trimmed.faces)
    np.testing.assert_array_equal(got.vertices, trimmed.vertices)
