"""The brick-grid KNN engine of the port (``ops/brickknn.py``,
``ops/brickknn_kernel.py``) and its grid sibling (``ops/gridknn.py``)
against the JAX package on the same numpy clouds.

Tolerances:
* the cell-size estimate equal to 1 ulp (it sets every cell edge);
* the dense form against the JAX ``brick_knn(use_pallas=False)``: valid
  masks and drop counts equal, neighbour index sets equal on ≥ 99.9% of
  rows; where a set differs, every swapped neighbour ties with the k-th
  in the float32 matmul expansion both forms rank by (its rounding is
  ~2⁻²⁴·(|q|² + |p|²); the clump's coincident points tie exactly), a tie
  the two top-k selections break another way; d² equal to 1e-5 relative;
* the kernel path (its plain version, on the CPU) against the JAX
  ``brick_knn(use_pallas=True)`` in interpret mode: the TPU kernel clears
  the low 10 mantissa bits of d² to pack its lane id there (and floors d²
  at 1e-30 first), so d² agree to 2⁻¹³ relative (1e-29 absolute), index
  sets on ≥ 99.5% of rows, and a swapped neighbour lies within 2⁻¹³
  relative of the k-th d² (a tie at the TPU's precision);
* the rescue pass and the grid engine: rows and counts as the JAX package
  reports them, d² to 1e-5 relative.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from structured_light_for_3d_model_replication_tpu.ops import brickknn as jbk
from structured_light_for_3d_model_replication_tpu.ops import gridknn as jgk
from structured_light_for_3d_model_replication_tpu_torch.ops import (
    brickknn,
    brickknn_kernel,
    gridknn,
)

K = 8
TPU_REL = 2.0 ** -13


@pytest.fixture(scope="module", autouse=True)
def _threads():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    old = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(old)


def _surface(rng, n):
    t = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(0, 160, n)
    pts = np.stack([80 * np.cos(t), z, 80 * np.sin(t)], -1)
    return (pts + rng.normal(0, 0.3, pts.shape)).astype(np.float32)


def _cloud(name):
    """3,000 points each: a cylinder surface, a Gaussian volume, a surface
    with a 100-point clump that overflows its 32-slot brick, and a surface
    with 30% of its points masked."""
    rng = np.random.default_rng(11)
    if name == "surface":
        return _surface(rng, 3000), None
    if name == "gauss":
        return (rng.normal(size=(3000, 3)) * 30).astype(np.float32), None
    if name == "clump":
        return np.vstack([_surface(rng, 2900),
                          np.full((100, 3), 40.0, np.float32)]), None
    return _surface(rng, 3000), rng.random(3000) > 0.3


# Each cloud once, exclude_self alternating: both settings on each form.
CASES = [("surface", True), ("gauss", False), ("clump", True),
         ("masked", False)]


def _run_both(name, exclude_self, use_pallas):
    pts, valid = _cloud(name)
    jd, ji, jv, jn = jbk.brick_knn(
        pts, K, points_valid=None if valid is None else jnp.asarray(valid),
        exclude_self=exclude_self, use_pallas=use_pallas,
        return_dropped=True)
    d, i, v, nd = brickknn.brick_knn(
        torch.tensor(pts), K,
        points_valid=None if valid is None else torch.tensor(valid),
        exclude_self=exclude_self, use_pallas=use_pallas,
        return_dropped=True)
    return ((np.asarray(jd), np.asarray(ji), np.asarray(jv), int(jn)),
            (d.numpy(), i.numpy(), v.numpy(), nd), pts)


def _set_mismatch(ji, jv, i, v):
    return np.array([set(a[m]) != set(b[w])
                     for a, b, m, w in zip(ji, i, jv, v)])


def _swapped_dists(pts, row, ji, jv, i, v):
    """Exact d² of the neighbours in one set and not the other, and the
    rounding scale of the matmul expansion for them, 2⁻²⁰·(|q|² + |p|²)."""
    sw = sorted(set(ji[row][jv[row]]) ^ set(i[row][v[row]]))
    q = pts[row].astype(np.float64)
    p = pts[sw].astype(np.float64)
    return (np.sum((q - p) ** 2, -1),
            2.0 ** -20 * (np.sum(q * q) + np.sum(p * p, -1)))


@pytest.mark.parametrize("name", ["surface", "gauss", "clump", "masked"])
@pytest.mark.parametrize("k", [8, 20])
def test_estimate_cell_size_matches_jax(name, k):
    pts, valid = _cloud(name)
    if valid is None:
        valid = np.ones(len(pts), bool)
    a = np.float32(jgk._estimate_cell_size(jnp.asarray(pts),
                                           jnp.asarray(valid), k))
    b = np.float32(gridknn._estimate_cell_size(torch.tensor(pts),
                                               torch.tensor(valid), k))
    assert abs(int(a.view(np.int32)) - int(b.view(np.int32))) <= 1, (a, b)


@pytest.mark.parametrize("name,exclude_self", CASES)
def test_dense_form_matches_jax(name, exclude_self):
    (jd, ji, jv, jn), (d, i, v, nd), pts = _run_both(name, exclude_self,
                                                     False)
    assert jn == nd
    assert np.array_equal(jv, v)
    bad = _set_mismatch(ji, jv, i, v)
    # The clump's 32 coincident points tie exactly at the k-th distance.
    assert bad.mean() <= 1e-3 or name == "clump", bad.mean()
    for row in np.nonzero(bad)[0]:   # every differing row is such a tie
        sw, tol = _swapped_dists(pts, row, ji, jv, i, v)
        assert np.all(np.abs(sw - d[row][v[row]][-1]) <= tol), row
    np.testing.assert_allclose(d[v], jd[v], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,exclude_self", CASES)
def test_kernel_path_matches_jax_interpret(name, exclude_self):
    (jd, ji, jv, jn), (d, i, v, nd), pts = _run_both(name, exclude_self,
                                                     True)
    assert jn == nd
    assert np.array_equal(jv, v)
    bad = _set_mismatch(ji, jv, i, v)
    assert bad.mean() <= 5e-3, bad.mean()
    for row in np.nonzero(bad)[0]:
        kth = d[row][v[row]][-1]
        sw, _ = _swapped_dists(pts, row, ji, jv, i, v)
        assert np.all(np.abs(sw - kth) <= TPU_REL * kth + 1e-29), (sw, kth)
    np.testing.assert_allclose(d[v], jd[v], rtol=TPU_REL, atol=1e-29)
    if exclude_self:
        assert not np.any((i == np.arange(len(pts))[:, None]) & v)
    # Exact d², ascending, ties to the smaller index.
    exact = np.sum((pts[:, None, :].astype(np.float32) - pts[i]) ** 2, -1)
    np.testing.assert_array_equal(d[v], exact[v])
    full = v.all(1)
    assert np.all(np.diff(d[full], axis=1) >= 0)
    tie = (np.diff(d[full], axis=1) == 0)
    assert np.all(np.diff(i[full], axis=1)[tie] > 0)


def test_kernel_path_recall_against_brute_force():
    """The kernel path reaches the JAX tests' oracle recall on a surface
    (≥ 0.99) and a Gaussian volume (≥ 0.96)."""
    for name, floor in (("surface", 0.99), ("gauss", 0.96)):
        pts, _ = _cloud(name)
        _, idx, ok = brickknn.brick_knn(torch.tensor(pts), K,
                                        exclude_self=True, use_pallas=True)
        idx, ok = idx.numpy(), ok.numpy()
        ref = cKDTree(pts).query(pts, k=K + 1)[1][:, 1:]
        rec = np.mean([np.isin(idx[r][ok[r]], ref[r]).mean()
                       for r in range(len(pts)) if ok[r].any()])
        assert rec >= floor, (name, rec)


def test_brick_knn_cells_plain_semantics():
    """The kernel's plain version on a hand-made table: exact d², ties to
    the smaller id, the own id skipped, only the first ``nnb`` neighbour
    bricks read, missing entries (+inf, −1)."""
    rng = np.random.default_rng(3)
    c, s = 3, brickknn_kernel.S
    xyz = rng.integers(0, 4, (c, s, 3)).astype(np.float32)  # many ties
    ids = rng.permutation(c * s).reshape(c, s).astype(np.int32)
    xyz[2, 5:] = np.inf
    ids[2, 5:] = -1
    bricks = np.concatenate([xyz.view(np.int32), ids[..., None]], -1)
    nbr = np.array([[0, 1, 2] + [0] * 24, [1, 0] + [1] * 25,
                    [2] + [2] * 26], np.int32)
    nnb = np.array([3, 2, 1], np.int32)
    k = 12
    for ex in (False, True):
        d, i = brickknn_kernel.brick_knn_cells(
            torch.tensor(bricks), torch.tensor(nbr), torch.tensor(nnb), k,
            ex)
        d, i = d.numpy().reshape(c, s, k), i.numpy().reshape(c, s, k)
        for cell in range(c):
            cand = np.concatenate([xyz[b] for b in nbr[cell, :nnb[cell]]])
            cid = np.concatenate([ids[b] for b in nbr[cell, :nnb[cell]]])
            for q in range(s):
                if ids[cell, q] < 0:
                    assert np.all(np.isinf(d[cell, q]))
                    assert np.all(i[cell, q] == -1)
                    continue
                diff = xyz[cell, q] - cand
                dd = (diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]) \
                    + diff[:, 2] * diff[:, 2]
                ok = np.isfinite(dd) & ((cid != ids[cell, q]) | (not ex))
                order = np.lexsort((cid[ok], dd[ok]))[:k]
                m = len(order)
                np.testing.assert_array_equal(d[cell, q, :m], dd[ok][order])
                np.testing.assert_array_equal(i[cell, q, :m], cid[ok][order])
                assert np.all(np.isinf(d[cell, q, m:]))
                assert np.all(i[cell, q, m:] == -1)


def test_brick_knn_dispatch_and_fit():
    """``use_pallas=None`` takes the dense form for a CPU tensor; forcing
    the kernel path outside its fit raises, as in the JAX package."""
    pts = torch.tensor(_cloud("surface")[0])
    d0, i0, v0 = brickknn.brick_knn(pts, K, exclude_self=True)
    d1, i1, v1 = brickknn.brick_knn(pts, K, exclude_self=True,
                                    use_pallas=False)
    assert torch.equal(d0, d1) and torch.equal(i0, i1)
    with pytest.raises(ValueError, match="brick kernel requires"):
        brickknn.brick_knn(pts, 33, use_pallas=True)
    with pytest.raises(ValueError, match="brick kernel requires"):
        brickknn.brick_knn(pts, K, slots=16, use_pallas=True)
    with pytest.raises(ValueError, match="must be int32"):
        brickknn_kernel.brick_knn_cells(
            torch.zeros((1, 32, 4)), torch.zeros((1, 27), dtype=torch.int32),
            torch.ones(1, dtype=torch.int32), K, False)


@pytest.mark.parametrize("slots,k,n,failed", [
    (32, 32, 2**24, ""),
    (16, 20, 1000, "slots=32 (got 16)"),
    (32, 33, 1000, "k<=32 (got 33)"),
    (32, 20, 2**24 + 1, f"n<={2**24} (got {2**24 + 1})"),
    (16, 40, 2**25, f"slots=32 (got 16) and k<=32 (got 40) and n<={2**24} "
                    f"(got {2**25})"),
])
def test_kernel_misfit_names_each_condition(slots, k, n, failed):
    """The JAX package's fit conditions of the kernel path; a CUDA tensor
    that misses them is logged with this text before the dense form runs,
    and ``use_pallas=True`` raises with it."""
    assert brickknn.kernel_misfit(slots, k, n) == failed


@pytest.mark.parametrize("max_rescue", [16, 128])
def test_rescue_dropped_matches_jax(max_rescue):
    """The exact second pass over the clump's dropped rows: the remaining
    count, the rescued rows and the untouched rows as the JAX package has
    them."""
    pts, _ = _cloud("clump")
    jd, ji, jv, jn = (np.asarray(a) for a in jbk.brick_knn(
        pts, 10, exclude_self=True, return_dropped=True, rescue=True,
        max_rescue=max_rescue))
    d, i, v, nd = brickknn.brick_knn(
        torch.tensor(pts), 10, exclude_self=True, return_dropped=True,
        rescue=True, max_rescue=max_rescue)
    d, i, v = d.numpy(), i.numpy(), v.numpy()
    assert int(jn) == nd
    assert np.array_equal(jv, v)
    bad = _set_mismatch(ji, jv, i, v)
    for row in np.nonzero(bad)[0]:
        sw, tol = _swapped_dists(pts, row, ji, jv, i, v)
        assert np.all(np.abs(sw - d[row][v[row]][-1]) <= tol), row
    np.testing.assert_allclose(d[v], jd[v], rtol=1e-5, atol=1e-5)
    # Rescued rows against the port's own pass on the dropped rows.
    _, _, v0, nd0 = brickknn.brick_knn(torch.tensor(pts), 10,
                                       exclude_self=True,
                                       return_dropped=True)
    rescued = ~v0.numpy().any(1) & v.any(1)
    assert rescued.sum() == min(nd0, max_rescue)


@pytest.mark.parametrize("exclude_self", [True, False])
def test_grid_knn_matches_jax(exclude_self):
    pts, valid = _cloud("masked")
    jd, ji, jv = (np.asarray(a) for a in jgk.grid_knn(
        pts, 20, points_valid=jnp.asarray(valid), exclude_self=exclude_self))
    d, i, v = (a.numpy() for a in gridknn.grid_knn(
        torch.tensor(pts), 20, points_valid=torch.tensor(valid),
        exclude_self=exclude_self))
    assert np.array_equal(jv, v)
    assert _set_mismatch(ji, jv, i, v).mean() <= 1e-3
    np.testing.assert_allclose(d[v], jd[v], rtol=1e-5, atol=1e-6)
