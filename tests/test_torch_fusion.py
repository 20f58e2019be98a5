"""The port's ``fusion/`` package, its TSDF ``mesh_from_cloud`` and its PLY
mesh codec against the JAX package's on the same numpy inputs, on the CPU.

Tolerances:
* ``extract_colored`` on the same volume state: the same face count and
  faces, vertices to 1e-5, colours ±1 (uint8 rounding of float32
  interpolations);
* incremental == batch integration (the port alone): weights to 1e-4, TSDF
  to 1e-3 and RGB to 0.1 where observed — the JAX package's bar
  (tests/test_fusion.py), scatter order differs;
* ``mesh_from_cloud(representation="tsdf")``: face counts within 1% and the
  median symmetric vertex gap ≤ 0.05 voxel (the integrate's float32 sums
  run in another order), colours present; ``"archival"`` is the Poisson
  path: within 1% of the JAX package's archival faces;
* PLY: the two codecs read each other's files to the same arrays, binary
  and ASCII (ASCII keeps six decimals).
"""

import io
import os

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from structured_light_for_3d_model_replication_tpu.fusion import (
    extract as jextract,
)
from structured_light_for_3d_model_replication_tpu.io import ply as jply
from structured_light_for_3d_model_replication_tpu.models import (
    meshing as jmeshing,
)
from structured_light_for_3d_model_replication_tpu.ops import tsdf as jtsdf
from structured_light_for_3d_model_replication_tpu_torch.fusion import (
    TSDFParams,
    TSDFPreviewMesher,
    TSDFVolume,
    extract_colored,
)
from structured_light_for_3d_model_replication_tpu_torch.io import ply
from structured_light_for_3d_model_replication_tpu_torch.io.stl import (
    TriangleMesh,
)
from structured_light_for_3d_model_replication_tpu_torch.models import (
    meshing,
)
from structured_light_for_3d_model_replication_tpu_torch.ops import tsdf


@pytest.fixture(autouse=True, scope="module")
def _share_cores_with_workers():
    """Give this module's PyTorch ops the worker's share of the cores (see
    tests/test_torch_meshing.py)."""
    n = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, n // workers))
    yield
    torch.set_num_threads(n)


def _colored_sphere(n, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts = u.astype(np.float32)
    cols = ((u * 0.5 + 0.5) * 255.0).astype(np.float32)
    return pts, u.astype(np.float32), cols


def _jax_volume_state(n=4000, depth=6, cap=1024):
    pts, nrm, cols = _colored_sphere(n)
    params = jtsdf.TSDFParams(grid_depth=depth, max_bricks=cap)
    origin = np.full(3, -1.3, np.float32)
    voxel = 2.6 / 2 ** depth
    state, _ = jtsdf.integrate(jtsdf.init_state(params), params, pts, cols,
                               np.ones(n, bool), -nrm, origin, voxel,
                               use_pallas=False)
    return state, params, origin, voxel


def _to_port(jstate) -> tsdf.TSDFState:
    return tsdf.TSDFState(*(torch.from_numpy(np.array(a)) for a in jstate))


@pytest.mark.parametrize("trim", [0.0, 0.1])
def test_extract_colored_matches_jax(trim):
    jstate, jp, origin, voxel = _jax_volume_state()
    tp = TSDFParams(grid_depth=jp.grid_depth, max_bricks=jp.max_bricks)
    ref = jextract.extract_colored(jstate, jp, origin, voxel,
                                   quantile_trim=trim)
    got = extract_colored(_to_port(jstate), tp, origin, voxel,
                          quantile_trim=trim)
    assert len(got.faces) == len(ref.faces) > 500
    np.testing.assert_array_equal(got.faces, ref.faces)
    np.testing.assert_allclose(got.vertices, ref.vertices, atol=1e-5)
    diff = np.abs(got.vertex_colors.astype(int)
                  - ref.vertex_colors.astype(int))
    assert diff.max() <= 1


def test_extract_empty_volume():
    tp = TSDFParams(grid_depth=5, max_bricks=16)
    vol = TSDFVolume(tp, np.zeros(3, np.float32), 0.1, device="cpu")
    mesh = vol.extract()
    assert mesh.vertices.shape == (0, 3) and mesh.faces.shape == (0, 3)


def test_incremental_matches_batch():
    pts, nrm, cols = _colored_sphere(4000, 1)
    valid = np.ones(4000, bool)
    params = TSDFParams(grid_depth=6, max_bricks=1024)
    batch = TSDFVolume.from_bounds(params, pts.min(0), pts.max(0),
                                   device="cpu")
    batch.integrate_oriented(pts, cols, valid, nrm)
    incr = TSDFVolume(params, batch.origin, batch.voxel_size, device="cpu")
    for k in range(4):
        sl = slice(k * 1000, (k + 1) * 1000)
        incr.integrate_oriented(pts[sl], cols[sl], valid[sl], nrm[sl])
    tb, wb, rb = batch.to_dense()
    ti, wi, ri = incr.to_dense()
    np.testing.assert_allclose(wb, wi, atol=1e-4)
    obs = wb > 1e-6
    np.testing.assert_allclose(tb[obs], ti[obs], atol=1e-3)
    np.testing.assert_allclose(rb[obs], ri[obs], atol=0.1)
    assert incr.stats()["stops_integrated"] == 4


def test_preview_mesher_integrates_and_extracts():
    """The TSDF previewer: lazy bounds at the first stop, one integrate per
    stop, a coloured extraction that ignores the model buffer."""
    pts, nrm, cols = _colored_sphere(3000, 2)
    pm = TSDFPreviewMesher(voxel_size_hint=0.05,
                           params=TSDFParams(grid_depth=6, max_bricks=512),
                           device="cpu")
    assert len(pm(None, None).faces) == 0
    cam = np.array([0.0, 0.0, -4.0], np.float32)
    t = torch.from_numpy
    pm.integrate_stop(t(pts), t(cols), t(np.ones(3000, bool)), cam,
                      moved_np=pts)
    mesh = pm(None, None)
    assert len(mesh.faces) > 100 and mesh.vertex_colors is not None
    assert pm.volume.voxel_size >= 0.05
    assert pm.stats()["stops_integrated"] == 1


def _cloud(module, n=3000, seed=3):
    pts, nrm, cols = _colored_sphere(n, seed)
    pts = pts * 40.0 + np.float32([0.0, 10.0, 500.0])
    return module.PointCloud(points=pts, normals=nrm,
                             colors=cols.astype(np.uint8))


def test_mesh_from_cloud_tsdf_matches_jax():
    ref = jmeshing.mesh_from_cloud(_cloud(jply), representation="tsdf",
                                   depth=6, quantile_trim=0.0,
                                   tsdf_max_bricks=2048)
    got = meshing.mesh_from_cloud(_cloud(ply), representation="tsdf",
                                  depth=6, quantile_trim=0.0,
                                  tsdf_max_bricks=2048, device="cpu")
    assert got.vertex_colors is not None and got.vertex_colors.dtype == \
        np.uint8
    assert abs(len(got.faces) - len(ref.faces)) <= 0.01 * len(ref.faces)
    voxel = 1.3 * 80.0 / 64
    gap = np.concatenate([cKDTree(ref.vertices).query(got.vertices)[0],
                          cKDTree(got.vertices).query(ref.vertices)[0]])
    assert np.median(gap) <= 0.05 * voxel


def test_mesh_from_cloud_archival_is_the_poisson_path():
    ref = jmeshing.mesh_from_cloud(_cloud(jply), representation="archival",
                                   depth=6)
    got = meshing.mesh_from_cloud(_cloud(ply), representation="archival",
                                  depth=6, device="cpu")
    poisson = meshing.mesh_from_cloud(_cloud(ply), depth=6, device="cpu")
    assert len(got.faces) == len(poisson.faces)
    assert abs(len(got.faces) - len(ref.faces)) <= 0.01 * len(ref.faces)
    assert got.vertex_colors is None


def _mesh(seed=0, colors=True, normals=True):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(50, 3)).astype(np.float32)
    f = rng.integers(0, 50, size=(80, 3)).astype(np.int32)
    m = TriangleMesh(v, f)
    if normals:
        m.vertex_normals = rng.normal(size=(50, 3)).astype(np.float32)
    if colors:
        m.vertex_colors = rng.integers(0, 256, (50, 3)).astype(np.uint8)
    return m


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("extras", [(True, True), (False, False)])
def test_ply_mesh_round_trip_across_codecs(binary, extras):
    mesh = _mesh(colors=extras[0], normals=extras[1])
    tol = 0.0 if binary else 5e-6
    ntol = 0.0 if binary else 5e-5
    for writer, reader in ((ply.write_ply_mesh, ply.read_ply_mesh),
                           (ply.write_ply_mesh, jply.read_ply_mesh),
                           (jply.write_ply_mesh, ply.read_ply_mesh)):
        buf = io.BytesIO()
        writer(buf, mesh, binary=binary)
        buf.seek(0)
        back = reader(buf)
        np.testing.assert_array_equal(back.faces, mesh.faces)
        np.testing.assert_allclose(back.vertices, mesh.vertices, atol=tol)
        if extras[0]:
            np.testing.assert_array_equal(back.vertex_colors,
                                          mesh.vertex_colors)
            np.testing.assert_allclose(back.vertex_normals,
                                       mesh.vertex_normals, atol=ntol)
        else:
            assert back.vertex_colors is None and back.vertex_normals is None
    buf = io.BytesIO()
    ply.write_ply_mesh(buf, mesh, binary=binary)
    jbuf = io.BytesIO()
    jply.write_ply_mesh(jbuf, mesh, binary=binary)
    assert buf.getvalue() == jbuf.getvalue()


def test_ply_mesh_rejects_non_triangles():
    buf = io.BytesIO(b"ply\nformat ascii 1.0\nelement vertex 4\n"
                     b"property float x\nproperty float y\nproperty float z\n"
                     b"element face 1\nproperty list uchar int vertex_indices"
                     b"\nend_header\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n4 0 1 2 3\n")
    with pytest.raises(ValueError, match="non-triangle"):
        ply.read_ply_mesh(buf)
