"""The port's cloud → STL slice against the JAX package's on the same numpy
clouds, on the CPU: the STL codec, normal orientation (``orient_normals``,
radial, tangent, camera) and ``mesh_360`` at depth 9 end to end.

Tolerances:
* STL: files byte-equal to the JAX package's codec's; bit-equal vertices
  and faces through a binary round trip, 1e-6 relative through ASCII
  (``%e`` keeps seven digits);
* ``orient_normals`` and the radial and camera modes exact (same float32
  dot products and flips); estimated normals the same sign everywhere,
  ≥ 99% of them to 1e-4 and all to 1 − |n·n'| ≤ 1e-3 — the exact KNN's
  float32 sums can flip a near-tie neighbour; tangent (Hoppe MST, the
  scipy path on both sides, native libraries off) the same sign on ≥ 99.9%
  of points, for the same reason;
* ``mesh_360`` at depth 9 on two spheres far apart (a band of ~3100
  blocks): face counts within 1%, the median symmetric vertex-to-vertex
  distance ≤ 0.1 voxel, and the STL read back to the same triangles — the
  splat's and the CG's float32 sums run in another order, so the meshes
  agree as surfaces, not bit for bit.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from structured_light_for_3d_model_replication_tpu import native as jnative
from structured_light_for_3d_model_replication_tpu.io import ply as jply
from structured_light_for_3d_model_replication_tpu.io import stl as jstl
from structured_light_for_3d_model_replication_tpu.models import (
    meshing as jmeshing,
)
from structured_light_for_3d_model_replication_tpu.ops import (
    pointcloud as jpc,
)
from structured_light_for_3d_model_replication_tpu_torch import _native
from structured_light_for_3d_model_replication_tpu_torch.io import ply, stl
from structured_light_for_3d_model_replication_tpu_torch.models import (
    meshing,
)
from structured_light_for_3d_model_replication_tpu_torch.ops import (
    pointcloud,
)


@pytest.fixture(autouse=True, scope="module")
def _share_cores_with_workers():
    """Give this module's PyTorch ops the worker's share of the cores. Under
    xdist the workers share the host; each at its default thread count,
    ATen's OpenMP regions oversubscribe the cores and spin, which made
    these tests many times slower than one thread each does."""
    n = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, n // workers))
    yield
    torch.set_num_threads(n)


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


def _mesh(seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(40, 3)).astype(np.float32)
    f = rng.integers(0, 40, size=(60, 3)).astype(np.int32)
    f = f[(f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])]
    return v, f


@pytest.mark.parametrize("binary", [True, False])
def test_stl_round_trip_and_interchange(tmp_path, binary):
    v, f = _mesh()
    used = np.unique(f)
    ours = stl.TriangleMesh(v, f)
    stl.write_stl(tmp_path / "a.stl", ours, binary=binary)
    jstl.write_stl(tmp_path / "b.stl", jstl.TriangleMesh(v, f),
                   binary=binary)
    assert (tmp_path / "a.stl").read_bytes() == \
        (tmp_path / "b.stl").read_bytes()
    back = stl.read_stl(str(tmp_path / "a.stl"))
    other = jstl.read_stl(str(tmp_path / "a.stl"))
    np.testing.assert_array_equal(back.vertices, other.vertices)
    np.testing.assert_array_equal(back.faces, other.faces)
    assert len(back.faces) == len(f) and len(back.vertices) == len(used)
    np.testing.assert_allclose(back.vertices[back.faces], v[f],
                               rtol=0 if binary else 1e-6,
                               atol=0 if binary else 1e-6)
    np.testing.assert_array_equal(
        ours.compute_vertex_normals(),
        jstl.TriangleMesh(v, f).compute_vertex_normals())


@pytest.mark.parametrize("case", ["grid", "signed zeros", "nan"])
def test_read_stl_merges_vertices_as_jax_does(tmp_path, case):
    """The STL reader's integer-key merge (and its fallback to
    ``np.unique`` where ±0 or a NaN leaves the representative to the sort)
    gives the JAX reader's vertices and faces bit for bit: a grid with
    shared, negative and repeated coordinates, then one with a row of
    signed zeros or a NaN vertex."""
    rng = np.random.default_rng(3)
    g = rng.integers(-4, 5, size=(3000, 3)).astype(np.float32) * 0.5
    g[:, 1] += rng.integers(0, 2, 3000).astype(np.float32) * 1e-3
    if case == "signed zeros":
        g[::7, 0] = np.where(np.arange(len(g[::7])) % 2, 0.0, -0.0)
        g[::7, 2] = 0.0
    elif case == "nan":
        g[5] = np.nan
    path = str(tmp_path / "g.stl")
    with open(path, "wb") as fh:
        rec = np.zeros(1000, stl._BIN_DT)
        rec["v0"], rec["v1"], rec["v2"] = g[0::3], g[1::3], g[2::3]
        fh.write(b"\0" * 80 + np.uint32(1000).tobytes() + rec.tobytes())
    flat = g.reshape(-1, 3)
    assert (stl._merge_rows(flat) is None) == (case != "grid")
    back, other = stl.read_stl(path), jstl.read_stl(path)
    np.testing.assert_array_equal(back.vertices.view(np.uint32),
                                  other.vertices.view(np.uint32))
    np.testing.assert_array_equal(back.faces, other.faces)
    assert len(back.vertices) < len(flat)


def test_orient_normals_matches_jax():
    pts, nrm = _spheres(2000, 1)
    flip = np.random.default_rng(2).random(2000) > 0.5
    nrm = np.where(flip[:, None], -nrm, nrm)
    loc = np.array([10.0, 20.0, 300.0], np.float32)
    for outward in (False, True):
        ref = np.asarray(jpc.orient_normals(pts, nrm, loc, outward=outward))
        got = pointcloud.orient_normals(
            torch.tensor(pts), torch.tensor(nrm), torch.tensor(loc),
            outward=outward).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mode", ["radial", "camera"])
def test_radial_and_camera_orientation_match_jax(mode):
    pts, nrm = _spheres(3000, 3)
    flipped = np.where((np.arange(3000) % 3 == 0)[:, None], -nrm, nrm)
    cam = np.array([0.0, 0.0, 0.0], np.float32)
    kw = dict(camera=cam) if mode == "camera" else {}
    ref = jmeshing.ensure_oriented_normals(
        jply.PointCloud(points=pts, normals=flipped.copy()), mode, **kw)
    cloud = ply.PointCloud(points=pts, normals=flipped.copy())
    got = meshing.ensure_oriented_normals(cloud, mode, device="cpu", **kw)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert cloud.normals is got


def test_estimated_normals_match_jax():
    """Without normals both estimate them (k = 30 PCA) and orient them
    radially: the same sign everywhere, directions to 1e-4."""
    pts, _ = _spheres(3000, 4, noise=0.05)
    ref = np.asarray(jmeshing.ensure_oriented_normals(
        jply.PointCloud(points=pts), "radial"))
    got = meshing.ensure_oriented_normals(ply.PointCloud(points=pts),
                                          "radial", device="cpu")
    dots = (got * ref).sum(1)
    assert np.all(dots > 0) and np.all(1 - dots <= 1e-3)
    assert (np.abs(got - ref).max(1) <= 1e-4).mean() >= 0.99


def test_tangent_orientation_matches_jax(monkeypatch):
    """Hoppe MST on both sides: the JAX package's scipy path against the
    port's (both native libraries switched off; the default, native, path
    is held in tests/test_torch_native.py)."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(_native, "available", lambda: False)
    pts, nrm = _spheres(3000, 5, noise=0.05)
    flipped = np.where((np.arange(3000) % 4 == 0)[:, None], -nrm, nrm)
    ref = np.asarray(jmeshing.ensure_oriented_normals(
        jply.PointCloud(points=pts, normals=flipped.copy()), "tangent"))
    got = meshing.ensure_oriented_normals(
        ply.PointCloud(points=pts, normals=flipped.copy()), "tangent",
        device="cpu")
    assert np.all(np.abs(got) == np.abs(flipped))
    assert ((got * ref).sum(1) > 0).mean() >= 0.999
    # Both spheres come out outward (per component, rooted at its furthest
    # point from the cloud's centroid).
    out = (got * (pts - CENTERS[np.arange(3000) % 2])).sum(1) > 0
    assert out.mean() >= 0.999


@pytest.fixture(scope="module")
def two_sphere_meshes(tmp_path_factory):
    """``mesh_360`` at depth 9 of the same two-sphere cloud, JAX and port,
    each into an STL. The port extracts with its device extractor (plain
    versions here), the one the card runs; the JAX side with its host
    oracle. Both give the same face count on the same grid
    (tests/test_torch_marching.py)."""
    pts, _ = _spheres(6000, 0)
    out = tmp_path_factory.mktemp("mesh360")
    kw = dict(depth=9, cg_iters=100, max_blocks=4096)
    st_j, st_t, timing = {}, {}, {}
    mesh_j = jmeshing.mesh_360(jply.PointCloud(points=pts.copy()),
                               str(out / "jax.stl"), solve_stats=st_j, **kw)
    mesh_t = meshing.mesh_360(ply.PointCloud(points=pts.copy()),
                              str(out / "port.stl"), solve_stats=st_t,
                              timing=timing, extraction="device",
                              device="cpu", **kw)
    return pts, mesh_j, mesh_t, st_j, st_t, timing, out / "port.stl"


def test_mesh_360_matches_jax(two_sphere_meshes):
    pts, mesh_j, mesh_t, st_j, st_t, _, _ = two_sphere_meshes
    assert len(mesh_j.faces) > 100_000
    assert abs(len(mesh_t.faces) - len(mesh_j.faces)) \
        <= 0.01 * len(mesh_j.faces)
    assert abs(st_t["cg_iters_used"] - st_j["cg_iters_used"]) <= 2
    voxel = 1.2 * float((pts.max(0) - pts.min(0)).max()) / (2 ** 9 - 1)
    gap = np.concatenate([cKDTree(mesh_j.vertices).query(mesh_t.vertices)[0],
                          cKDTree(mesh_t.vertices).query(mesh_j.vertices)[0]])
    assert np.median(gap) <= 0.1 * voxel
    # Every vertex sits near one of the spheres' surfaces (radius 25).
    r = np.linalg.norm(mesh_t.vertices[:, None, :] - CENTERS[None], axis=2)
    assert np.median(np.abs(r.min(1) - 25.0)) < voxel


def test_mesh_360_stl_round_trip(two_sphere_meshes):
    _, _, mesh_t, _, st_t, timing, path = two_sphere_meshes
    back = stl.read_stl(str(path))
    assert len(back.faces) == len(mesh_t.faces)
    np.testing.assert_array_equal(back.vertices[back.faces],
                                  mesh_t.vertices[mesh_t.faces])
    assert {"normals_s", "setup_s", "coarse_s", "fine_cg_s", "iso_s",
            "extract_s"} <= set(timing)
    assert st_t["n_blocks"] <= 4096 and st_t["preconditioner"] == "additive"


def test_dense_depth_meshes_on_the_dense_solve():
    pts, nrm = _spheres(3000, 6)
    cloud = ply.PointCloud(points=pts, normals=nrm.copy())
    timing = {}
    mesh = meshing.mesh_from_cloud(cloud, depth=6, quantile_trim=0.0,
                                   timing=timing, device="cpu")
    ref = jmeshing.mesh_from_cloud(jply.PointCloud(points=pts,
                                                   normals=nrm.copy()),
                                   depth=6, quantile_trim=0.0)
    assert "solve_s" in timing
    assert abs(len(mesh.faces) - len(ref.faces)) <= 0.01 * len(ref.faces)


@pytest.mark.parametrize("kw,what", [
    (dict(mode="surface"), "device_mesh"),
    (dict(representation="tsdf"), "device_mesh"),
    (dict(), "device_mesh"),
])
def test_left_out_modes_name_their_step(monkeypatch, kw, what):
    """``device_mesh`` runs, as in the JAX package: the ball pivot and the
    TSDF representation ignore it, bit-equal to the call without it, and
    the dense solve spreads over the mesh's two host members, a slab of
    grid planes each, whose sums fold in member order: CG iterations
    within 1, χ and iso within 1e-5·max|χ| of the plain grid, faces
    within 0.5% (tests/test_torch_poisson_slabs.py's bounds). The
    pipelined worker gives the same mesh."""
    from structured_light_for_3d_model_replication_tpu_torch.parallel import (
        mesh as pmesh,
    )

    real, solves = meshing.poisson.reconstruct, []

    def recorded(*args, **kw):
        grid, iters = real(*args, **dict(kw, return_iters=True))
        solves.append((grid, iters))
        return grid

    monkeypatch.setattr(meshing.poisson, "reconstruct", recorded)
    pts, nrm = _spheres(200, 7)
    two = pmesh.serve_space_mesh(2, devices=[torch.device("cpu", 0),
                                             torch.device("cpu", 1)])
    kw = dict(kw, depth=5, quantile_trim=0.0)
    plain = meshing.mesh_from_cloud(ply.PointCloud(points=pts, normals=nrm),
                                    device="cpu", **kw)
    got = meshing.mesh_from_cloud(ply.PointCloud(points=pts, normals=nrm),
                                  device="cpu", **{what: two}, **kw)
    assert len(got.faces) > 100
    if solves:
        (ref, ref_iters), (grid, iters) = solves
        scale = float(ref.chi.abs().max())
        assert abs(iters - ref_iters) <= 1
        assert float((grid.chi - ref.chi).abs().max()) <= 1e-5 * scale
        assert abs(float(grid.iso) - float(ref.iso)) <= 1e-5 * scale
        assert abs(len(got.faces) - len(plain.faces)) \
            <= 0.005 * len(plain.faces)
    else:
        assert np.array_equal(got.vertices, plain.vertices)
        assert np.array_equal(got.faces, plain.faces)
    task = meshing.mesh_from_cloud_async(
        ply.PointCloud(points=pts, normals=nrm), device="cpu",
        **{what: two}, **kw)
    joined = task.result(timeout=60)
    assert np.array_equal(joined.vertices, got.vertices)
    assert np.array_equal(joined.faces, got.faces)
    with pytest.raises(ValueError, match="representation"):
        meshing.mesh_from_cloud(ply.PointCloud(points=pts),
                                representation="voxels", device="cpu")


@pytest.mark.parametrize("kw", [
    dict(depth=14), dict(depth=9, preconditioner="chebyshev"),
    dict(depth=9, preconditioner="vcycle"),
], ids=["depth-14", "chebyshev", "vcycle"])
def test_deep_options_reach_the_band_solver(monkeypatch, kw):
    """Depths 14-16 and every preconditioner pass from ``mesh_from_cloud``
    to the band solver unchanged (a spy on it, which shortens the coarse
    solve), and a mesh comes back."""
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        poisson_sparse,
    )

    seen = []
    real = poisson_sparse.reconstruct_sparse

    def spy(*args, **call):
        seen.append(call)
        return real(*args, coarse_iters=20, **call)

    monkeypatch.setattr(poisson_sparse, "reconstruct_sparse", spy)
    pts, nrm = _spheres(200, 7)
    mesh = meshing.mesh_from_cloud(ply.PointCloud(points=pts, normals=nrm),
                                   cg_iters=2, max_blocks=6144,
                                   quantile_trim=0.0, device="cpu", **kw)
    assert len(seen) == 1
    assert seen[0]["depth"] == kw["depth"]
    assert seen[0]["preconditioner"] == kw.get("preconditioner", "additive")
    assert len(mesh.faces) > 0 and np.isfinite(mesh.vertices).all()


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts, nrm = _spheres(200, 8)
    for call in (lambda: meshing.mesh_360(ply.PointCloud(points=pts),
                                          str(tmp_path / "m.stl")),
                 lambda: meshing.reconstruct_stl(ply.PointCloud(points=pts),
                                                 str(tmp_path / "m.stl")),
                 lambda: meshing.ensure_oriented_normals(
                     ply.PointCloud(points=pts, normals=nrm))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    mesh = meshing.reconstruct_stl(ply.PointCloud(points=pts, normals=nrm),
                                   str(tmp_path / "m.stl"), depth=5,
                                   device="cpu")
    assert len(stl.read_stl(str(tmp_path / "m.stl")).faces) == \
        len(mesh.faces) > 0


def test_mesh_modules_do_not_load_kernel_bindings():
    """Importing slice 2's modules loads neither the CUDA bindings
    (``kernels/``), nor jax, nor the JAX package — in a fresh interpreter,
    since this process already holds jax."""
    port = "structured_light_for_3d_model_replication_tpu_torch"
    jax_pkg = "structured_light_for_3d_model_replication_tpu"
    code = textwrap.dedent(f"""
        import sys
        from {port}.models import meshing
        from {port}.ops import (marching, marching_classify, marching_device,
                                orientation, poisson, poisson_matvec,
                                poisson_sparse)
        from {port}.io import stl
        bad = [m for m in sys.modules if m.startswith("{port}.kernels")
               or m == "triton" or m == "jax" or m.startswith("jax.")
               or m == "{jax_pkg}" or m.startswith("{jax_pkg}.")]
        assert not bad, bad
    """)
    proc = subprocess.run([sys.executable, "-c", code],
                          cwd=Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=120,
                          check=False)
    assert proc.returncode == 0, proc.stdout + proc.stderr
