"""The port's marching extractors against the JAX package's on the same
grids, on the CPU: the classify pass (``ops/marching_classify.py``), the
device extractor (``ops/marching_device.py``, run here on its plain
versions) and the host NumPy oracle (``ops/marching.py``).

Tolerances:
* the classify pass (frame + mask + count) exact against JAX
  ``_phase_corners`` on hand-made and random bands, the frame bit for bit
  (among subnormals each mask is pinned to its own compare rule, see
  ``test_classify_bricks_matches_jax_phase``); the mask exact against
  ``classify_pallas(c9 - iso, interpret=True)`` gathered at the cell
  positions and masked;
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


_OFFS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1),
         (0, 1, 1), (1, 1, 1))   # the nb8 columns, in order
_UNITS = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
          (0, 0, -1))            # the nbr columns, in order


def _band(coords):
    """Brick coords (M, 3) → the (M, 6) int32 face-neighbour table, M for
    an absent neighbour (as the band-sparse solve builds it)."""
    slot = {tuple(c): i for i, c in enumerate(np.asarray(coords).tolist())}
    m = len(slot)
    return np.array([[slot.get(tuple(np.add(c, u).tolist()), m)
                      for u in _UNITS] for c in slot], np.int32).reshape(m, 6)


def _random_band(rng, m_max, grid=4, keep=0.6):
    """A ragged band: the bricks of a grid³ block kept at random, in
    shuffled slot order."""
    cells = np.array([[x, y, z] for x in range(grid) for y in range(grid)
                      for z in range(grid)])
    cells = cells[rng.random(len(cells)) < keep][:m_max]
    return cells[rng.permutation(len(cells))]


def _np_active(c9, iso, valid, flush):
    """NumPy classify of a frame; ``flush`` compares as under flush-to-zero
    (subnormal operands read as 0, as XLA's CPU backend does)."""
    if flush:
        tiny = np.finfo(np.float32).tiny
        c9 = np.where(np.abs(c9) < tiny, np.float32(0), c9)
        iso = np.float32(0) if abs(iso) < tiny else iso
    inside = (c9 > np.float32(iso))[:, jmj._CIDX]               # (M, 512, 8)
    return inside.any(-1) & ~inside.all(-1) & valid[:, None]


def _case(name, rng):
    """(chi, nbr, block_valid, iso) of one named classify case."""
    iso = np.float32(0.0137)
    if name.startswith("absent "):
        off = _OFFS[int(name.split()[1])]
        coords = [o for o in _OFFS if o != off]
    elif name == "diagonal by one hop order":
        # +xy of brick 0 only through +y then +x; its +x neighbour absent.
        coords = [(0, 0, 0), (0, 1, 0), (1, 1, 0), (0, 0, 1), (0, 1, 1)]
    elif name == "diagonal in the band, unreachable":
        coords = [(0, 0, 0), (1, 1, 0), (1, 1, 1)]
    elif name == "M = 0":
        coords = np.zeros((0, 3), np.int64)
    else:
        coords = _random_band(rng, 37)
    m = len(coords)
    nbr = _band(coords)
    valid = np.ones(m, bool)
    if name in ("invalid bricks", "ragged M"):
        valid = rng.random(m) > 0.3
    if name == "iso +- 1 ulp":
        pick = rng.integers(-1, 2, (m, 512))
        chi = np.where(pick < 0, np.nextafter(iso, np.float32(-1)),
                       np.where(pick > 0, np.nextafter(iso, np.float32(1)),
                                iso)).astype(np.float32)
    elif name == "iso 0 among subnormals":
        iso = np.float32(0.0)
        sub = np.float32(np.finfo(np.float32).smallest_subnormal)
        chi = np.array([-sub, np.float32(-0.0), np.float32(0.0), sub,
                        sub * 7, np.float32(1e-38)],
                       np.float32)[rng.integers(0, 6, (m, 512))]
    else:
        chi = (rng.normal(size=(m, 512)) * 0.05 + iso).astype(np.float32)
        chi[:, ::11] = iso   # corners exactly at iso: inside is strict
    return chi, nbr, valid, iso


_CASES = ([f"absent {j}" for j in range(1, 8)]
          + ["diagonal by one hop order", "diagonal in the band, unreachable",
             "invalid bricks", "iso +- 1 ulp", "iso 0 among subnormals",
             "M = 0", "ragged M"])


@pytest.mark.parametrize("name", _CASES)
def test_classify_bricks_matches_jax_phase(name):
    """The port's classify pass on the CPU against JAX ``_phase_corners``:
    the frame bit for bit, the mask and its count exactly. Among subnormals
    the two differ by design: XLA's CPU backend compares with subnormals
    read as 0 (the TPU has none), the port as PyTorch does (gradual
    underflow, as the kernel is built); the frames still agree bit for
    bit, and each mask is pinned to its own rule."""
    chi, nbr, valid, iso = _case(name, np.random.default_rng(7))
    c9_j, act_j, n_j = (np.asarray(a) for a in jmj._phase_corners(
        jnp.asarray(chi), jnp.asarray(nbr), jnp.asarray(valid),
        jnp.float32(iso)))
    nb8 = marching_device._nb8_table(torch.tensor(nbr))
    c9, act, n = marching_classify.classify_bricks(
        torch.tensor(chi), nb8, torch.tensor(iso), torch.tensor(valid))
    assert c9.dtype == torch.float32 and act.dtype == torch.bool
    assert n.dtype == torch.int32 and n.shape == ()
    np.testing.assert_array_equal(c9.numpy().view(np.int32),
                                  c9_j.view(np.int32))
    if name == "iso 0 among subnormals":
        np.testing.assert_array_equal(act_j, _np_active(c9_j, iso, valid,
                                                        True))
        want = _np_active(c9_j, iso, valid, False)
        assert (want != act_j).any()
        np.testing.assert_array_equal(act.numpy(), want)
        assert int(n) == int(want.sum())
        return
    np.testing.assert_array_equal(act.numpy(), act_j)
    assert int(n) == int(n_j)
    if name != "M = 0":
        assert 0 < int(n) < act.numel()


def test_classify_bricks_clamps_absent_neighbours():
    """Brick 0 of a full 2×2×2 block reads every +face from its
    neighbours; with a neighbour gone its corners on that face, edge or
    corner come from its own clamp voxel instead."""
    rng = np.random.default_rng(5)
    chi = rng.normal(size=(8, 512)).astype(np.float32)
    full = _band(_OFFS)
    nb8 = marching_device._nb8_table(torch.tensor(full))
    c9, _, _ = marching_classify.classify_bricks(
        torch.tensor(chi), nb8, 0.0, torch.ones(8, dtype=torch.bool))
    c9 = c9.numpy()[0].reshape(9, 9, 9)
    own = chi[0].reshape(8, 8, 8)
    np.testing.assert_array_equal(c9[:8, :8, :8], own)
    np.testing.assert_array_equal(c9[8, :8, :8], chi[1].reshape(8, 8, 8)[0])
    for j in range(1, 8):
        cut = nb8.clone()
        cut[0, j] = 8
        c9c, _, _ = marching_classify.classify_bricks(
            torch.tensor(chi), cut, 0.0, torch.ones(8, dtype=torch.bool))
        c9c = c9c.numpy()[0].reshape(9, 9, 9)
        hit = np.zeros((9, 9, 9), bool)
        x8, y8, z8 = _OFFS[j]
        hit[8 if x8 else slice(0, 8), 8 if y8 else slice(0, 8),
            8 if z8 else slice(0, 8)] = True
        clamp = own[np.minimum(np.arange(9), 7)][:, np.minimum(
            np.arange(9), 7)][:, :, np.minimum(np.arange(9), 7)]
        np.testing.assert_array_equal(c9c[hit], clamp[hit])
        np.testing.assert_array_equal(c9c[~hit], c9[~hit])


@pytest.mark.parametrize("iso", [0.0, 0.37])
def test_classify_matches_pallas(iso):
    """The mask against ``classify_pallas(c9 - iso, interpret=True)``
    gathered at the cell positions and masked, on a random ragged band; the
    plain classify half (``classify_cells_reference``) on the same frame
    too."""
    rng = np.random.default_rng(3)
    coords = _random_band(rng, 96, grid=6)
    m = len(coords)
    chi = (rng.normal(size=(m, 512)) + iso).astype(np.float32)
    chi[:, ::7] = np.float32(iso)   # corners exactly at iso: strict compare
    valid = rng.random(m) > 0.2
    nb8 = marching_device._nb8_table(torch.tensor(_band(coords)))
    c9, got, n = marching_classify.classify_bricks(
        torch.tensor(chi), nb8, torch.tensor(iso, dtype=torch.float32),
        torch.tensor(valid))
    any_f, all_f = (np.asarray(a) for a in jmp.classify_pallas(
        jnp.asarray(c9.numpy()) - jnp.float32(iso), interpret=True))
    cid = jmj._CIDX[:, 0]
    ref = (any_f[:, cid] > 0.5) & (all_f[:, cid] < 0.5) & valid[:, None]
    assert got.shape == (m, 512) and int(n) == int(ref.sum()) > 0
    np.testing.assert_array_equal(got.numpy(), ref)
    plain = marching_classify.classify_cells_reference(
        c9, iso, torch.tensor(valid)).numpy()
    np.testing.assert_array_equal(plain, ref)


def test_classify_checks_operands():
    chi = torch.zeros((4, 512))
    nb8 = torch.zeros((4, 8), dtype=torch.int64)
    ok = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="512"):
        marching_classify.classify_bricks(torch.zeros((4, 729)), nb8, 0.0, ok)
    with pytest.raises(ValueError, match=r"\(M, 8\)"):
        marching_classify.classify_bricks(chi, nb8[:, :6], 0.0, ok)
    with pytest.raises(ValueError, match="block_valid"):
        marching_classify.classify_bricks(chi, nb8, 0.0, ok[:3])
    with pytest.raises(ValueError, match="float32"):
        marching_classify.classify_bricks(chi.double(), nb8, 0.0, ok)
    with pytest.raises(ValueError, match="int64"):
        marching_classify.classify_bricks(chi, nb8.int(), 0.0, ok)
    with pytest.raises(ValueError, match="bool"):
        marching_classify.classify_bricks(chi, nb8, 0.0, ok.int())
    with pytest.raises(ValueError, match="meta"):
        marching_classify.classify_bricks(chi, nb8.to("meta"), 0.0, ok)
    with pytest.raises(ValueError, match="no kernel"):
        marching_classify.classify_bricks(chi.to("meta"), nb8.to("meta"),
                                          0.0, ok.to("meta"))


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
