"""The port's marching extractors against the JAX package's on the same
grids, on the CPU: the classify pass (``ops/marching_classify.py``), the
device extractor (``ops/marching_device.py``, run here on its plain
versions) and the host NumPy oracle (``ops/marching.py``).

Tolerances:
* classify exact, against ``classify_pallas(c9 - iso, interpret=True)``
  gathered at the cell positions and masked, and against the XLA form;
* the static tables equal the JAX package's;
* device extractor on a JAX grid carried across by ``grid_from_numpy``:
  the same face count as JAX ``extract_sparse_jax(use_pallas=False)``, and
  vertices within 1e-4 world units of it (the same float32 arithmetic; in
  practice bit-equal); against the host oracle the contract of
  tests/test_marching_jax.py — identical face count, vertex counts within
  0.5%, triangle centroids within 1e-3;
* the host oracle and the dense ``extract`` equal the JAX package's.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.ops import marching as jm
from structured_light_for_3d_model_replication_tpu.ops import (
    marching_jax as jmj,
)
from structured_light_for_3d_model_replication_tpu.ops import (
    marching_pallas as jmp,
)
from structured_light_for_3d_model_replication_tpu.ops import poisson as jpo
from structured_light_for_3d_model_replication_tpu.ops import (
    poisson_sparse as jps,
)
from structured_light_for_3d_model_replication_tpu_torch.ops import (
    marching,
    marching_classify,
    marching_device,
    poisson,
    poisson_sparse,
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


def _sphere_cloud(rng, n, r=50.0):
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    return (u * r).astype(np.float32), u.astype(np.float32)


@pytest.fixture(scope="module")
def grids():
    """One small band-sparse JAX solve (as tests/test_marching_jax.py) and
    the same grid carried into the port."""
    pts, nrm = _sphere_cloud(np.random.default_rng(0), 8_000)
    g, n_blocks = jps.reconstruct_sparse(
        pts, nrm, depth=6, cg_iters=80, max_blocks=2048, coarse_depth=5,
        coarse_iters=100, preconditioner="jacobi")
    assert int(n_blocks) <= 2048
    t = poisson_sparse.grid_from_numpy(
        {k: np.asarray(v) for k, v in g._asdict().items()}, device="cpu")
    return g, t


def test_tables_match_jax():
    np.testing.assert_array_equal(marching_classify._CIDX, jmj._CIDX)
    for name in ("_CASE9", "_SRC9", "_CLAMP9", "_NTRI", "_EP_CUBE", "_FLIP",
                 "_CELL_XYZ"):
        np.testing.assert_array_equal(getattr(marching_device, name),
                                      getattr(jmj, name), err_msg=name)
    np.testing.assert_array_equal(marching._TETS, jm._TETS)
    np.testing.assert_array_equal(marching._CORNERS, jm._CORNERS)
    assert [marching_device._bucket(n) for n in (0, 4096, 4097, 10 ** 6)] \
        == [jmj._bucket(n) for n in (0, 4096, 4097, 10 ** 6)]


@pytest.mark.parametrize("iso", [0.0, 0.37])
def test_classify_matches_pallas(iso):
    rng = np.random.default_rng(3)
    c9 = (rng.normal(size=(96, 729)) + iso).astype(np.float32)
    # A few corners exactly at iso: inside is strictly c9 > iso.
    c9[:, ::7] = np.float32(iso)
    valid = rng.random(96) > 0.2
    any_f, all_f = (np.asarray(a) for a in jmp.classify_pallas(
        jnp.asarray(c9) - jnp.float32(iso), interpret=True))
    cid = jmj._CIDX[:, 0]
    ref = (any_f[:, cid] > 0.5) & (all_f[:, cid] < 0.5) & valid[:, None]
    got = marching_classify.classify_cells(
        torch.tensor(c9), torch.tensor(iso, dtype=torch.float32),
        torch.tensor(valid)).numpy()
    assert got.dtype == bool and got.shape == (96, 512)
    np.testing.assert_array_equal(got, ref)
    plain = marching_classify.classify_cells_reference(
        torch.tensor(c9), iso, torch.tensor(valid)).numpy()
    np.testing.assert_array_equal(plain, ref)


def test_classify_checks_operands():
    c9 = torch.zeros((4, 729))
    with pytest.raises(ValueError, match="729"):
        marching_classify.classify_cells(c9[:, :512], 0.0,
                                         torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="float32"):
        marching_classify.classify_cells(c9.double(), 0.0,
                                         torch.ones(4, dtype=torch.bool))


def test_corners_match_jax(grids):
    g, t = grids
    c9_j, act_j, n_j = (np.asarray(a) for a in jmj._phase_corners(
        g.chi, g.nbr, g.block_valid, jnp.float32(g.iso)))
    c9_t, act_t, n_t = marching_device._phase_corners(
        t.chi, t.nbr, t.block_valid, t.iso)
    np.testing.assert_array_equal(c9_t.numpy(), c9_j)
    np.testing.assert_array_equal(act_t.numpy(), act_j)
    assert int(n_t) == int(n_j) > 0


def test_device_extractor_matches_jax_and_oracle(grids):
    g, t = grids
    mesh_j = jmj.extract_sparse_jax(g, use_pallas=False)
    mesh_d = marching_device.extract_sparse_device(t)
    mesh_h = marching.extract_sparse(t, engine="host")
    assert len(mesh_d.faces) == len(mesh_j.faces) > 5_000
    assert len(mesh_d.vertices) == len(mesh_j.vertices)
    np.testing.assert_allclose(mesh_d.vertices, mesh_j.vertices, atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(mesh_d.faces, mesh_j.faces)
    # Against the host oracle: the contract of tests/test_marching_jax.py.
    assert len(mesh_d.faces) == len(mesh_h.faces)
    assert abs(len(mesh_d.vertices) - len(mesh_h.vertices)) \
        <= 0.005 * len(mesh_h.vertices)
    cen_h = np.asarray(mesh_h.vertices, np.float64)[mesh_h.faces].mean(1)
    cen_d = np.asarray(mesh_d.vertices, np.float64)[mesh_d.faces].mean(1)
    sub = cen_d[:: max(1, len(cen_d) // 256)][:256]
    d2 = ((sub[:, None, :] - cen_h[None, :, :]) ** 2).sum(-1)
    assert float(np.sqrt(d2.min(axis=1)).max()) < 1e-3
    # Winding: every sphere triangle's normal points away from the centre.
    v = np.asarray(mesh_d.vertices, np.float64)[mesh_d.faces]
    n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    cen = v.mean(axis=1)
    assert ((n * (cen - cen.mean(axis=0))).sum(-1) > 0).mean() > 0.99


def test_readback_is_vertices_and_faces_only(grids):
    _, t = grids
    mesh = marching_device.extract_sparse_device(t)
    rb = marching_device.LAST_READBACK
    assert set(rb) == {"counts", "vertices", "faces"}
    assert rb["vertices"] == len(mesh.vertices) * 3 * 4
    assert rb["faces"] == len(mesh.faces) * 3 * 4
    assert rb["counts"] <= 16


def test_quantile_trim_matches_jax(grids):
    g, t = grids
    full = marching_device.extract_sparse_device(t)
    trim_d = marching_device.extract_sparse_device(t, quantile_trim=0.25)
    trim_j = jmj.extract_sparse_jax(g, quantile_trim=0.25, use_pallas=False)
    assert 0 < len(trim_d.faces) < len(full.faces)
    assert len(trim_d.faces) == len(trim_j.faces)


def test_engine_dispatch(grids, monkeypatch):
    """``"auto"`` keeps a CPU grid on the host oracle; ``"device"`` takes the
    device extractor; an unknown engine or a grid without ``nbr`` is
    refused where it must be."""
    _, t = grids
    calls = []
    real = marching_device.extract_sparse_device
    monkeypatch.setattr(marching_device, "extract_sparse_device",
                        lambda grid, quantile_trim=0.0: calls.append(1)
                        or real(grid, quantile_trim))
    auto = marching.extract_sparse(t, engine="auto")
    assert not calls
    dev = marching.extract_sparse(t, engine="device")
    assert calls and len(dev.faces) == len(auto.faces)
    with pytest.raises(ValueError, match="engine"):
        marching.extract_sparse(t, engine="gpu")
    bare = t._replace(nbr=None)
    with pytest.raises(ValueError, match="nbr"):
        real(bare)
    assert len(marching.extract_sparse(bare, engine="auto").faces) > 5_000


def test_host_oracle_matches_jax(grids):
    g, t = grids
    a = jm.extract_sparse(g, engine="host")
    b = marching.extract_sparse(t, engine="host")
    np.testing.assert_array_equal(b.vertices, a.vertices)
    np.testing.assert_array_equal(b.faces, a.faces)
    np.testing.assert_allclose(b.vertex_normals, a.vertex_normals, atol=1e-6)


def test_dense_extract_matches_jax():
    pts, nrm = _sphere_cloud(np.random.default_rng(1), 4_000)
    g = jpo.reconstruct(pts, nrm, depth=5)
    t = poisson.PoissonGrid(*(torch.tensor(np.asarray(a)) for a in g))
    for trim in (0.0, 0.1):
        a = jm.extract(g, quantile_trim=trim)
        b = marching.extract(t, quantile_trim=trim)
        assert len(b.faces) == len(a.faces) > 1_000
        np.testing.assert_array_equal(b.vertices, a.vertices)
        np.testing.assert_array_equal(b.faces, a.faces)


def test_nb8_table_chains_diagonals():
    """Diagonal neighbours assemble from face hops; absent stays M."""
    coords = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                       for z in (0, 1)])
    m = 8

    def slot(c):
        c = np.asarray(c)
        if (c < 0).any() or (c > 1).any():
            return m
        return int((c[0] * 2 + c[1]) * 2 + c[2])

    units = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
             (0, 0, -1)]
    nbr = np.array([[slot(c + np.asarray(u)) for u in units]
                    for c in coords], np.int32)
    nb8 = marching_device._nb8_table(torch.tensor(nbr)).numpy()
    np.testing.assert_array_equal(
        nb8, np.asarray(jmj._nb8_table(jnp.asarray(nbr))))
    offs = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
            (1, 1, 0), (1, 0, 1), (0, 1, 1), (1, 1, 1)]
    for i, c in enumerate(coords):
        for j, o in enumerate(offs):
            assert nb8[i, j] == slot(c + np.asarray(o)), (i, j)
