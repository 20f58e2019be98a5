"""Point-cloud ops of the port against the JAX package on the same numpy
inputs: exact KNN, voxel downsample, stratified indices, SOR, PCA normals,
the closed-form 3×3 eigensolver, the fused Morton SOR + normals and FPFH.

Tolerances:
* masks, counts and indices exact (stratified indices also on the tiered
  search the JAX package takes at n ≥ 2¹⁸);
* KNN neighbour sets equal on ≥ 99.9% of rows — the matmul expansion's
  float32 sums are formed in another order, which can flip near-ties; the
  Morton engine reports the raw expansion, so there ≥ 99.5% of rows with
  every distance within 0.25 mm²;
* floats rtol 1e-5; normals up to sign, where JAX leaves the sign free,
  with atol 1e-4 — an eigenvector moves by ulp / eigengap, and a few
  near-degenerate neighbourhoods have small gaps;
* the fused SOR + normals forms each covariance as s2/cnt − μμᵀ at ~500 mm
  offsets, which cancels, and its matmul sums run in another order: its
  normals agree to 1 − |n·n'| ≤ 1e-6 at the median and ≤ 5e-4 (1.8°) at
  worst.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.ops import features as jfeat
from structured_light_for_3d_model_replication_tpu.ops import knn as jknn
from structured_light_for_3d_model_replication_tpu.ops import mortonknn as jmk
from structured_light_for_3d_model_replication_tpu.ops import pointcloud as jpc
from structured_light_for_3d_model_replication_tpu.ops import (
    sor_normals as jsn,
)
from structured_light_for_3d_model_replication_tpu_torch.ops import (
    features,
    knn,
    mortonknn,
    pointcloud,
    sor_normals,
)


def _surface(n, seed, outliers=30):
    """A noisy sphere shell at scan scale (mm, ~500 mm from the camera) with
    a few gross outliers and a random invalid mask."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts = u * 80 + rng.normal(0, 0.5, (n, 3)) + np.array([0, 0, 500])
    pts[:outliers] += rng.normal(0, 60, (outliers, 3))
    return pts.astype(np.float32), rng.random(n) > 0.1


@pytest.fixture(scope="module")
def cloud():
    return _surface(3000, 0)


def _t(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def _same_sets(a, b):
    return np.array([set(x) == set(y) for x, y in zip(a, b)])


@pytest.mark.parametrize("k,exclude_self", [(20, False), (20, True),
                                            (100, False)])
def test_knn_neighbor_sets_match_jax(cloud, k, exclude_self):
    pts, valid = cloud
    P, V = _t(pts, valid)
    d, i, v = knn.knn(P, k, points_valid=V, exclude_self=exclude_self)
    jd, ji, jv = jknn.knn(jnp.asarray(pts), k, points_valid=jnp.asarray(valid),
                          exclude_self=exclude_self, method="exact")
    same = _same_sets(i.numpy(), np.asarray(ji))
    assert same.mean() >= 0.999
    assert np.array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_allclose(d.numpy()[same], np.asarray(jd)[same],
                               rtol=1e-5, atol=1e-5)
    assert valid[i.numpy()[v.numpy()]].all()


def test_knn_cross_query_k1_matches_jax(rng):
    """k = 1 queries against another set (the feature-matching form, here
    33-D) take the first occurrence on ties, like the JAX running argmin."""
    keys = rng.random((700, 33)).astype(np.float32)
    qs = rng.random((500, 33)).astype(np.float32)
    kv = rng.random(700) > 0.2
    d, i, v = knn.knn(torch.from_numpy(keys), 1, queries=torch.from_numpy(qs),
                      points_valid=torch.from_numpy(kv))
    jd, ji, jv = jknn.knn(jnp.asarray(keys), 1, queries=jnp.asarray(qs),
                          points_valid=jnp.asarray(kv))
    assert (i.numpy() == np.asarray(ji)).mean() >= 0.999
    assert np.array_equal(v.numpy(), np.asarray(jv))


def test_voxel_downsample_matches_jax(cloud):
    pts, valid = cloud
    P, V = _t(pts, valid)
    colors = (pts * 0.3) % 255
    out = pointcloud.voxel_downsample(P, 6.0, valid=V,
                                      attrs=torch.from_numpy(colors))
    jout = jpc.voxel_downsample(jnp.asarray(pts), 6.0,
                                valid=jnp.asarray(valid),
                                attrs=jnp.asarray(colors), with_attrs=True)
    assert int(out[3]) == int(jout[3]) > 100
    assert np.array_equal(out[2].numpy(), np.asarray(jout[2]))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jout[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(jout[1]),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n,m,frac", [(997, 256, 0.7), (64, 32, 0.2),
                                      (300_000, 16_384, 0.7)])
def test_stratified_indices_match_jax(n, m, frac):
    valid = np.random.default_rng(n).random(n) < frac
    idx, ok = pointcloud.stratified_indices(torch.from_numpy(valid), m)
    jidx, jok = jpc.stratified_indices(jnp.asarray(valid), m)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(ok.numpy(), np.asarray(jok))


def test_stratified_subsample_matches_jax(cloud):
    pts, valid = cloud
    P, V = _t(pts, valid)
    attrs = torch.arange(len(pts), dtype=torch.float32)[:, None]
    out, oa, ov = pointcloud.stratified_subsample(P, 512, valid=V, attrs=attrs)
    jo, joa, jov = jpc.stratified_subsample(jnp.asarray(pts), 512,
                                            valid=jnp.asarray(valid),
                                            attrs=jnp.asarray(attrs.numpy()))
    assert np.array_equal(out.numpy(), np.asarray(jo))
    assert np.array_equal(oa.numpy(), np.asarray(joa))
    assert np.array_equal(ov.numpy(), np.asarray(jov))


def test_statistical_outlier_removal_matches_jax(cloud):
    pts, valid = cloud
    P, V = _t(pts, valid)
    keep = pointcloud.statistical_outlier_removal(P, V, nb_neighbors=20)
    jkeep = jpc.statistical_outlier_removal(jnp.asarray(pts),
                                            jnp.asarray(valid),
                                            nb_neighbors=20)
    assert np.array_equal(keep.numpy(), np.asarray(jkeep))
    assert 0 < int(keep.sum()) < int(valid.sum())


def test_smallest_eigenvector_sym3_matches_jax(rng):
    a = rng.normal(size=(500, 3, 3)).astype(np.float32)
    a = a + a.transpose(0, 2, 1)
    a[0] = np.eye(3, dtype=np.float32)      # isotropic: ẑ fallback
    v = pointcloud.smallest_eigenvector_sym3(torch.from_numpy(a)).numpy()
    jv = np.asarray(jpc.smallest_eigenvector_sym3(jnp.asarray(a)))
    np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-5)
    assert np.array_equal(v[0], [0.0, 0.0, 1.0])


def test_estimate_normals_matches_jax(cloud):
    pts, valid = cloud
    P, V = _t(pts, valid)
    # Same neighbourhoods on both sides (the JAX sweep), so the comparison
    # isolates the covariance + eigensolve.
    nb = jknn.knn(jnp.asarray(pts), 12, points_valid=jnp.asarray(valid),
                  method="exact")
    n, nv = pointcloud.estimate_normals(P, V, k=12,
                                        neighbors=_t(*nb))
    jn, jnv = jpc.estimate_normals(jnp.asarray(pts), jnp.asarray(valid),
                                   k=12, neighbors=nb)
    assert np.array_equal(nv.numpy(), np.asarray(jnv))
    m = nv.numpy()
    sign = np.sign(np.sum(n.numpy() * np.asarray(jn), axis=1))[:, None]
    np.testing.assert_allclose((n.numpy() * sign)[m], np.asarray(jn)[m],
                               rtol=1e-5, atol=1e-4)
    # The port's own sweep gives the same validity (≥ 3 valid neighbours).
    _, nv2 = pointcloud.estimate_normals(P, V, k=12)
    assert np.array_equal(nv2.numpy(), np.asarray(jnv))


def test_morton_code_matches_jax(rng):
    cell = rng.integers(0, 1024, (1000, 3)).astype(np.int32)
    got = mortonknn.morton_code(torch.from_numpy(cell)).numpy()
    assert np.array_equal(got, np.asarray(jmk.morton_code(jnp.asarray(cell))))


@pytest.mark.parametrize("exclude_self", [False, True])
def test_morton_knn_matches_jax(exclude_self):
    """The large-n branch of ``_self_knn``: same curve, same windows, exact
    selection in each. Its distances are the raw matmul expansion (not
    recomputed), so near-ties flip more often than in ``knn``: sets equal
    on ≥ 99.5% of rows, distances within 0.25 mm² on every row."""
    pts, valid = _surface(4096, 2)
    P, V = _t(pts, valid)
    d, i, v = mortonknn.morton_knn(P, 20, points_valid=V,
                                   exclude_self=exclude_self)
    jd, ji, jv = jmk.morton_knn(jnp.asarray(pts), 20,
                                points_valid=jnp.asarray(valid),
                                exclude_self=exclude_self)
    same = _same_sets(i.numpy(), np.asarray(ji))
    assert same.mean() >= 0.995
    assert np.array_equal(v.numpy(), np.asarray(jv))
    # Every row's distances agree to 8 float32 ulps of |q|² + |p|² ≈ 5·10⁵
    # mm² (the expansion's cancellation), so differing sets are near-ties.
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=0.25)


def test_sor_normals_matches_jax():
    pts, valid = _surface(4096, 1, outliers=40)
    P, V = _t(pts, valid)
    keep, nrm, nv = sor_normals.sor_normals(P, V, k_normals=30)
    jkeep, jnrm, jnv = jsn.sor_normals(jnp.asarray(pts), jnp.asarray(valid),
                                       k_normals=30)
    assert np.array_equal(keep.numpy(), np.asarray(jkeep))
    assert np.array_equal(nv.numpy(), np.asarray(jnv))
    m = nv.numpy()
    dots = np.abs(np.sum(nrm.numpy() * np.asarray(jnrm), axis=1))[m]
    assert np.median(1.0 - dots) <= 1e-6
    assert (1.0 - dots).max() <= 5e-4
    assert 0 < int(keep.sum()) < int(valid.sum())


def test_fpfh_matches_jax(cloud):
    pts, valid = cloud
    P, V = _t(pts, valid)
    nb = jknn.knn(jnp.asarray(pts), 32, points_valid=jnp.asarray(valid),
                  method="exact")
    jn, jnv = jpc.estimate_normals(jnp.asarray(pts), jnp.asarray(valid),
                                   k=12, neighbors=nb)
    n_t, nv_t = _t(jn, jnv)
    f, fv = features.fpfh(P, n_t, 30.0, valid=nv_t, max_nn=32,
                          neighbors=_t(*nb))
    jf, jfv = jfeat.fpfh(jnp.asarray(pts), jn, 30.0, valid=jnv, max_nn=32,
                         neighbors=nb)
    assert np.array_equal(fv.numpy(), np.asarray(jfv))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-5,
                               atol=1e-3)
