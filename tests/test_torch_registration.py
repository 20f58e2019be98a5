"""Registration of the port against the JAX package on the same inputs:
Horn/Kabsch, mutual feature matching, ``log_so3``, ``chain_poses``, RANSAC
fed the SAME hypothesis draws (made with ``jax.random`` exactly as
``_ransac_core`` draws them), point-to-plane ICP from the same init, and
the information matrix.

Tolerances: transforms atol 1e-4; RANSAC fitness equal; ICP from the same
init within 0.05° and 0.05 mm with fitness ±0.005 (k = 1 correspondences
can flip between near-equidistant keys: the port's sweep is the exact
direct difference, the JAX CPU path the matmul expansion); information
matrices to 2e-5 of their largest entry (float32 sums of ~2·10³ terms of
up to 2.5·10⁵ mm² each, taken in another order, so the small off-diagonal
entries carry the large ones' rounding).

The sweeps bounded to a cloud's leading live rows (``knn``'s ``live``,
``register_pair``'s cells-only preprocess) are held to the port's own
dense sweeps, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.ops import pointcloud as jpc
from structured_light_for_3d_model_replication_tpu.ops import posegraph as jpg
from structured_light_for_3d_model_replication_tpu.ops import (
    registration as jreg,
)
from structured_light_for_3d_model_replication_tpu_torch.ops import (
    posegraph,
    registration,
)


def _rot(axis, deg):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    th = np.radians(deg)
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


def _rigid(R, t):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def _angle_deg(R):
    return np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))


@pytest.fixture(scope="module")
def pair():
    """A bumpy surface patch (mm scale) and the same surface moved by a
    known rigid step, sampled at different points, with normals."""
    rng = np.random.default_rng(5)

    def surface(n):
        xy = rng.uniform(-60, 60, (n, 2))
        z = (500 + 12 * np.sin(xy[:, 0] / 11) * np.cos(xy[:, 1] / 17)
             + 0.004 * xy[:, 0] ** 2)
        return np.column_stack([xy, z])

    T_true = _rigid(_rot([0.2, 1.0, 0.1], 4.0), [3.0, -2.0, 1.5])
    dst = surface(2048).astype(np.float32)
    src_world = surface(2048)
    # src = T_true⁻¹ · world, so T_true maps src onto dst.
    inv = np.linalg.inv(T_true.astype(np.float64))
    src = (src_world @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32)
    src_valid = rng.random(2048) > 0.05
    dst_valid = rng.random(2048) > 0.05
    nrm, nv = jpc.estimate_normals(jnp.asarray(dst), jnp.asarray(dst_valid),
                                   k=12)
    return dict(src=src, dst=dst, sv=src_valid, dv=dst_valid & np.asarray(nv),
                nrm=np.array(nrm), T=T_true)


def test_kabsch_matches_jax(rng):
    src = rng.normal(0, 40, (3, 200, 3)).astype(np.float32)
    T = _rigid(_rot([1, 2, 3], 30), [5, -3, 2])
    dst = (src @ T[:3, :3].T + T[:3, 3]
           + rng.normal(0, 0.1, src.shape)).astype(np.float32)
    w = rng.random((3, 200)).astype(np.float32)
    for conv in (False, True):
        got = registration.kabsch(torch.from_numpy(src), torch.from_numpy(dst),
                                  torch.from_numpy(w), ensure_converged=conv)
        ref = jreg.kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
                          ensure_converged=conv)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    # Degenerate (all-zero weights) → identity rotation, as in JAX.
    z = registration.kabsch(torch.from_numpy(src[0]), torch.from_numpy(dst[0]),
                            torch.zeros(200))
    np.testing.assert_allclose(z.numpy()[:3, :3], np.eye(3), atol=1e-6)


def test_triplet_rigid_matches_jax(rng):
    s = rng.normal(0, 30, (64, 3, 3)).astype(np.float32)
    d = rng.normal(0, 30, (64, 3, 3)).astype(np.float32)
    got = registration._triplet_rigid(torch.from_numpy(s), torch.from_numpy(d))
    ref = jax.vmap(jreg._triplet_rigid)(jnp.asarray(s), jnp.asarray(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_so3_helpers_match_jax(rng):
    for _ in range(5):
        w = rng.normal(0, 0.7, 3).astype(np.float32)
        R = registration.exp_so3(torch.from_numpy(w))
        np.testing.assert_allclose(R.numpy(),
                                   np.asarray(jreg.exp_so3(jnp.asarray(w))),
                                   atol=1e-6)
        np.testing.assert_allclose(posegraph.log_so3(R).numpy(),
                                   np.asarray(jpg.log_so3(jnp.asarray(
                                       R.numpy()))), atol=1e-5)
    eye = torch.eye(3)
    assert np.allclose(posegraph.log_so3(eye).numpy(), 0.0)


def test_chain_poses_matches_jax(rng):
    Ts = np.stack([_rigid(_rot(rng.normal(size=3), 15), rng.normal(0, 5, 3))
                   for _ in range(6)])
    got = posegraph.chain_poses(torch.from_numpy(Ts))
    ref = jpg.chain_poses(jnp.asarray(Ts))
    assert got.shape == (7, 4, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_match_features_matches_jax(rng):
    base = rng.random((600, 33)).astype(np.float32)
    src = base + rng.normal(0, 0.01, base.shape).astype(np.float32)
    dst = base[rng.permutation(600)]
    sv = rng.random(600) > 0.1
    dv = rng.random(600) > 0.1
    nn, ok = registration.match_features(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(sv),
        torch.from_numpy(dv))
    jnn, jok = jreg.match_features(jnp.asarray(src), jnp.asarray(dst),
                                   jnp.asarray(sv), jnp.asarray(dv))
    assert np.array_equal(ok.numpy(), np.asarray(jok))
    o = ok.numpy()
    assert o.sum() > 300
    assert np.array_equal(nn.numpy()[o], np.asarray(jnn)[o])


def _jax_ransac_samples(key, n, num_iterations, batch, ransac_n=3):
    """The draws ``_ransac_core`` makes: split the key per batch, split each
    batch key per hypothesis, ``randint(k, (ransac_n,), 0, n)`` each."""
    n_batches = max(1, num_iterations // batch)
    out = []
    for k in jax.random.split(key, n_batches):
        ks = jax.random.split(k, batch)
        out.append(jax.vmap(lambda kk: jax.random.randint(
            kk, (ransac_n,), 0, n))(ks))
    return np.asarray(jnp.stack(out)).astype(np.int64)


def test_ransac_core_with_same_samples_matches_jax(pair):
    src, dst, T = pair["src"], pair["dst"], pair["T"]
    n = len(src)
    rng = np.random.default_rng(9)
    # Correspondences: the true match for 60% of points, random otherwise.
    moved = src @ T[:3, :3].T + T[:3, 3]
    d2 = ((moved[:, None, :] - dst[None, :, :]) ** 2).sum(-1)
    corr = np.argmin(d2, axis=1)
    wrong = rng.random(n) > 0.6
    corr[wrong] = rng.integers(0, n, wrong.sum())
    corr_ok = pair["sv"] & (rng.random(n) > 0.05)
    key = jax.random.PRNGKey(3)
    num_it, batch = 4096, 1024
    ref = jreg._ransac_core(key, jnp.asarray(src), jnp.asarray(dst),
                            jnp.asarray(corr.astype(np.int32)),
                            jnp.asarray(corr_ok), 3.0, 0.9,
                            num_iterations=num_it, batch=batch, ransac_n=3)
    samples = _jax_ransac_samples(key, n, num_it, batch)
    got = registration._ransac_core(
        None, torch.from_numpy(src), torch.from_numpy(dst),
        torch.from_numpy(corr), torch.from_numpy(corr_ok), 3.0, 0.9,
        num_iterations=num_it, batch=batch, ransac_n=3,
        samples=torch.from_numpy(samples))
    np.testing.assert_allclose(got.transformation.numpy(),
                               np.asarray(ref.transformation), atol=1e-4)
    assert float(got.fitness) == float(ref.fitness)
    assert float(got.fitness) > 0.4
    assert _angle_deg(got.transformation.numpy()[:3, :3]
                      @ T[:3, :3].T) < 0.5


def test_ransac_samples_shape_and_range():
    g = torch.Generator().manual_seed(0)
    s = registration.ransac_samples(500, 100_000, 8192, g, "cpu")
    assert s.shape == (12, 8192, 3) and s.dtype == torch.int64
    assert int(s.min()) >= 0 and int(s.max()) < 500


def test_icp_same_init_matches_jax(pair):
    src, dst, T = pair["src"], pair["dst"], pair["T"]
    init = _rigid(_rot([0, 1, 0], 3.0), [2.0, -1.0, 1.0])
    sched = tuple(float(4.0 ** (1.0 - i / 19)) for i in range(20))
    kw = dict(max_correspondence_distance=3.0, max_iterations=20,
              method="point_to_plane", schedule=sched, warmup_subsample=4)
    ref = jreg.icp(jnp.asarray(src), jnp.asarray(dst), init=jnp.asarray(init),
                   dst_normals=jnp.asarray(pair["nrm"]),
                   src_valid=jnp.asarray(pair["sv"]),
                   dst_valid=jnp.asarray(pair["dv"]), **kw)
    got = registration.icp(torch.from_numpy(src), torch.from_numpy(dst),
                           init=torch.from_numpy(init),
                           dst_normals=torch.from_numpy(pair["nrm"]),
                           src_valid=torch.from_numpy(pair["sv"]),
                           dst_valid=torch.from_numpy(pair["dv"]), **kw)
    Tg = got.transformation.numpy()
    Tr = np.asarray(ref.transformation)
    assert _angle_deg(Tg[:3, :3] @ Tr[:3, :3].T) <= 0.05
    assert np.abs(Tg[:3, 3] - Tr[:3, 3]).max() <= 0.05
    assert abs(float(got.fitness) - float(ref.fitness)) <= 0.005
    # And both converge on the true step.
    assert _angle_deg(Tg[:3, :3] @ T[:3, :3].T) < 0.5
    assert float(got.fitness) > 0.8


def test_information_matrix_matches_jax(pair):
    src, dst, T = pair["src"], pair["dst"], pair["T"]
    got = registration.information_matrix(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(T),
        3.0, torch.from_numpy(pair["sv"]), torch.from_numpy(pair["dv"]))
    ref = jreg.information_matrix(jnp.asarray(src), jnp.asarray(dst),
                                  jnp.asarray(T), 3.0, jnp.asarray(pair["sv"]),
                                  jnp.asarray(pair["dv"]))
    assert got.shape == (6, 6)
    ref = np.asarray(ref)
    assert np.abs(got.numpy() - ref).max() <= 2e-5 * np.abs(ref).max()


def _cells(pair):
    """The pair's two surfaces padded to 4,096 slots and voxel-downsampled
    at 2 mm: every valid cell in the leading slots, as
    ``register_pair`` gives them to its sweeps."""
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        merge,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        pointcloud,
    )

    out = []
    for pts, valid in ((pair["src"], pair["sv"]), (pair["dst"], pair["dv"])):
        p, v = merge._pad_cloud(pts[valid], "cpu")
        p = torch.cat([p, p.new_zeros((4096 - len(p), 3))])
        v = torch.cat([v, v.new_zeros(4096 - len(v))])
        dpts, _, dvalid, n = pointcloud.voxel_downsample(p, 2.0, valid=v)
        out.append((p, v, dpts, dvalid, int(n)))
    return out


@pytest.mark.parametrize("k,exclude_self", [(30, False), (20, True), (1, False)])
def test_knn_live_rows_equal_the_dense_sweep(pair, k, exclude_self):
    """A self-query bounded to the downsampled cells gives the dense
    sweep's rows bit for bit, and every row past them neighbourless."""
    from structured_light_for_3d_model_replication_tpu_torch.ops.knn import (
        knn,
    )

    (_, _, dpts, dvalid, n), _ = _cells(pair)
    assert 0 < n < len(dpts) // 2 and not dvalid[n:].any()
    dense = knn(dpts, k, points_valid=dvalid, exclude_self=exclude_self)
    live = knn(dpts, k, points_valid=dvalid, exclude_self=exclude_self,
               live=(n, n))
    for a, b in zip(dense, live):
        assert a.shape == b.shape
        assert torch.equal(a[:n], b[:n])
    assert not live[2][n:].any() and not dense[2][n:].any()


def test_match_features_live_equals_the_dense_sweep(rng):
    """Mutual matching over the leading live rows of two feature sets
    (holes among them, nothing valid past them) equals the full sweep."""
    base = rng.random((3000, 33)).astype(np.float32)
    src = torch.from_numpy(base + rng.normal(0, 0.01, base.shape)
                           .astype(np.float32))
    dst = torch.from_numpy(base[rng.permutation(3000)])
    sv = torch.from_numpy(rng.random(3000) > 0.1)
    dv = torch.from_numpy(rng.random(3000) > 0.1)
    sv[1100:] = False
    dv[900:] = False
    nn, ok = registration.match_features(src, dst, sv, dv)
    lnn, lok = registration.match_features(src, dst, sv, dv,
                                           live=(1100, 900))
    assert torch.equal(ok, lok) and ok.sum() > 100
    assert torch.equal(nn[ok], lnn[ok])


def test_register_pair_sweeps_only_the_cells(rng):
    """``register_pair`` (its KNN and feature sweeps over the cells alone)
    gives the transform, fitness, rmse and information matrix of the same
    registration swept over every slot, bit for bit: a lopsided sphere
    onto itself turned 12° and shifted 8 mm, padded to twice its points,
    at the defaults of ``cli view --icp`` but 8,192 RANSAC draws."""
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        merge,
    )

    a = rng.normal(size=(1500, 3))
    a = 50.0 * a / np.linalg.norm(a, axis=1, keepdims=True)
    a[:200, 1] *= 1.6
    T_true = _rigid(_rot([0.0, 1.0, 0.0], 12.0), [8.0, 0.0, 0.0])
    b = a @ T_true[:3, :3].T.astype(np.float64) + T_true[:3, 3]
    clouds = []
    for pts in (a, b):
        p, v = merge._pad_cloud(pts.astype(np.float32), "cpu")
        clouds += [torch.cat([p, p.new_zeros((3072 - len(p), 3))]),
                   torch.cat([v, v.new_zeros(3072 - len(v))])]
    params = merge.MergeParams(voxel_size=merge._auto_voxel(a),
                               ransac_iterations=8192)
    g = torch.Generator()
    g.manual_seed(0)
    res, info = merge.register_pair(*clouds, params, generator=g)
    g = torch.Generator()
    g.manual_seed(0)
    sp, sv, dp, dv = clouds
    dense = merge.register_edge(
        merge.preprocess_registration_view(sp, sv, params),
        merge.preprocess_registration_view(dp, dv, params), params, g)
    for x, y in zip((res.transformation, res.fitness, res.inlier_rmse,
                     info), dense):
        assert torch.equal(x, y)
    T = res.transformation.numpy()
    assert float(res.fitness) > 0.9
    assert _angle_deg(T[:3, :3].T @ T_true[:3, :3]) < 0.5
