"""The headline 360° forms with fewer host syncs: ``fused=True`` (decode,
the batched ring, finalize and the ``output_cap`` compaction, one readback),
``scan_stream_to_cloud`` (the same tail after a chunked, staged decode) and
``ring_strategy="scan"`` — the port's against the JAX package's, on the
4-stop, 10° rig of tests/test_scan360.py with its FAST parameters
(``final_max_points=4096`` in both packages, which keeps the CPU's exact
final SOR small; ~1,500 cells survive, so no decimation).

The RANSAC streams differ (``torch.Generator`` vs ``jax.random``), so the
port is held to outcomes against the JAX package: every pose angle within
0.5° of the JAX pose's and within 3° of i·10°; per-edge fitness ±0.02; the
merged point count within 5% (with ``output_cap`` below the survivors both
return exactly ``output_cap`` points); colours uint8; normals float16 values
(rounded and widened) of unit length within 2e-3.

Within the port it is held to bits: the stream at ``stop_chunk=3`` (a ragged
last chunk of one stop, padded) against the fused form; ``ring_strategy=
"scan"`` on the multi-launch path against the fused form's poses; the
batched ``nearest_one`` plain version against the single-edge one looped
over the edges. Batched ``icp`` against per-edge ``icp`` at E = 3 is held to
1e-5 (transform elements, fitness, rmse): the batched normal equations sum
JᵀJ in a batched matrix product, whose order of additions may differ from
the single product's.
"""

import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.models import merge as jmerge
from structured_light_for_3d_model_replication_tpu.models import (
    scan360 as jscan360,
)
from structured_light_for_3d_model_replication_tpu.models import (
    synthetic as jsynthetic,
)
from structured_light_for_3d_model_replication_tpu.ops import (
    triangulate as jtri,
)
from structured_light_for_3d_model_replication_tpu_torch.models import (
    merge,
    scan360,
)
from structured_light_for_3d_model_replication_tpu_torch.ops import (
    nn,
    registration,
)
from structured_light_for_3d_model_replication_tpu_torch.ops import (
    triangulate as tri,
)

from .conftest import CAM_H, CAM_W, SMALL_PROJ

SPHERES = ((0.0, 10.0, 500.0, 80.0, 0.9), (60.0, -40.0, 460.0, 35.0, 0.7),
           (-70.0, 40.0, 530.0, 30.0, 0.8), (20.0, 70.0, 440.0, 25.0, 0.75))
FAST = dict(voxel_size=6.0, ransac_iterations=2048, icp_iterations=20,
            fpfh_max_nn=32, normals_k=12, max_points=2048,
            final_max_points=4096)
CAP = 512   # below the ~1,500 survivors: the compaction truncates


@pytest.fixture(scope="module", autouse=True)
def _threads():
    """This module's PyTorch ops get the worker's share of the cores (see
    tests/test_torch_meshing.py)."""
    n = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, n // workers))
    yield
    torch.set_num_threads(n)


def _angle(T):
    return np.degrees(np.arccos(np.clip((np.trace(T[:3, :3]) - 1) / 2,
                                        -1, 1)))


@pytest.fixture(scope="module")
def rig(synth_rig):
    scene = jsynthetic.Scene(wall_z=None, spheres=tuple(
        jsynthetic.Sphere((x, y, z), r, a) for x, y, z, r, a in SPHERES))
    cam_K, proj_K, R, T = synth_rig
    scans = jsynthetic.render_turntable_scans(
        scene, n_stops=4, degrees_per_stop=10.0, cam_K=cam_K, proj_K=proj_K,
        R=R, T=T, cam_height=CAM_H, cam_width=CAM_W, proj=SMALL_PROJ)
    stacks = np.stack([s for s, _ in scans])
    jcal = jtri.make_calibration(cam_K, proj_K, R, T, CAM_H, CAM_W,
                                 SMALL_PROJ.width, SMALL_PROJ.height)
    cal = tri.calibration_from_numpy(
        {k: np.asarray(v) for k, v in jcal._asdict().items()}, device="cpu")
    return stacks, jcal, cal


def _jax_fused(rig, output_cap):
    stacks, jcal, _ = rig
    params = jscan360.Scan360Params(
        merge=jmerge.MergeParams(**FAST), view_cap=8192, fused=True,
        stop_chunk=3, output_cap=output_cap)
    return jscan360.scan_stacks_to_cloud(
        jnp.asarray(stacks), jcal, SMALL_PROJ.col_bits, SMALL_PROJ.row_bits,
        params=params, with_stats=True)


@pytest.fixture(scope="module")
def jax_fused(rig):
    return _jax_fused(rig, None)


@pytest.fixture(scope="module")
def jax_fused_cap(rig):
    return _jax_fused(rig, CAP)


def _params(**kw):
    return scan360.Scan360Params(merge=merge.MergeParams(**FAST),
                                 view_cap=8192, stop_chunk=3, **kw)


def _port(rig, stream=False, host=False, **kw):
    stacks, _, cal = rig
    args = (cal, SMALL_PROJ.col_bits, SMALL_PROJ.row_bits)
    if stream:
        return scan360.scan_stream_to_cloud(iter(stacks), *args,
                                            params=_params(**kw),
                                            with_stats=True, device="cpu")
    return scan360.scan_stacks_to_cloud(
        stacks if host else torch.from_numpy(stacks), *args,
        params=_params(**kw), with_stats=True, device="cpu")


@pytest.fixture(scope="module")
def port_fused(rig):
    return _port(rig, fused=True)


@pytest.fixture(scope="module")
def port_fused_cap(rig):
    """The truncating run, with the warnings it logged."""
    seen = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: seen.append(record.getMessage())
    scan360.log.addHandler(handler)
    try:
        return _port(rig, fused=True, output_cap=CAP), seen
    finally:
        scan360.log.removeHandler(handler)


def _outcome_matches(ours, ref):
    merged, poses, stats = ours
    jmerged, jposes, jstats = ref
    assert poses.shape == (4, 4, 4) and poses.dtype == np.float32
    for i in range(4):
        a, ja = _angle(poses[i]), _angle(np.asarray(jposes[i]))
        assert abs(a - ja) <= 0.5, (i, a, ja)
        assert abs(a - 10.0 * i) <= 3.0, (i, a)
    fits = [e["fitness"] for e in stats["edges"]]
    jfits = [e["fitness"] for e in jstats["edges"]]
    assert len(fits) == len(jfits) == 3
    np.testing.assert_allclose(fits, jfits, atol=0.02)
    assert abs(len(merged) - len(jmerged)) <= 0.05 * len(jmerged)
    assert merged.colors.dtype == np.uint8
    assert merged.normals.dtype == np.float32
    assert np.array_equal(merged.normals,
                          merged.normals.astype(np.float16).astype(np.float32))
    np.testing.assert_allclose(np.linalg.norm(merged.normals, axis=1), 1.0,
                               atol=2e-3)
    assert np.isfinite(merged.points).all()


def test_fused_matches_jax_fused(port_fused, jax_fused):
    _outcome_matches(port_fused, jax_fused)
    assert len(port_fused[0]) > 200


def test_fused_output_cap_truncates_like_jax(port_fused_cap, jax_fused_cap,
                                             port_fused):
    capped = port_fused_cap[0]
    _outcome_matches(capped, jax_fused_cap)
    assert len(capped[0]) == len(jax_fused_cap[0]) == CAP
    assert len(port_fused[0]) > CAP
    # The same survivors, compacted: every kept point is one of the
    # uncompacted cloud's.
    full = {tuple(p) for p in port_fused[0].points.tolist()}
    assert all(tuple(p) in full for p in capped[0].points.tolist())
    np.testing.assert_array_equal(capped[1], port_fused[1])


def test_output_cap_warns_on_truncation(port_fused_cap, port_fused):
    assert any(f"truncated {len(port_fused[0])} survivors to "
               f"output_cap={CAP}" in m for m in port_fused_cap[1])


def test_stream_is_bit_equal_to_fused(rig, port_fused):
    """Chunks of 3 over 4 stops: the second chunk holds one stop, padded
    by repeating it. Same tail on the same decoded clouds: same bits."""
    timing = {}
    stacks, _, cal = rig
    merged, poses, stats = scan360.scan_stream_to_cloud(
        iter(stacks), cal, SMALL_PROJ.col_bits, SMALL_PROJ.row_bits,
        params=_params(), with_stats=True, timing=timing,
        device="cpu")
    fm, fp, fs = port_fused
    assert np.array_equal(poses, fp)
    assert np.array_equal(merged.points, fm.points)
    assert np.array_equal(merged.colors, fm.colors)
    assert np.array_equal(merged.normals, fm.normals)
    assert stats == fs
    assert len(timing["stage_decode_s"]) == 2
    assert timing["stops"] == 4 and timing["chunk"] == 3
    assert timing["tail_s"] > 0


def test_scan_strategy_gives_the_fused_poses(rig, port_fused):
    """The multi-launch path with the batched ring: the same ring, chain
    and poses as the fused form."""
    merged, poses, _ = _port(rig, host=True, ring_strategy="scan")
    assert np.array_equal(poses, port_fused[1])
    assert abs(len(merged) - len(port_fused[0])) <= 0.05 * len(merged)


def test_fused_on_host_arrays_takes_the_multi_launch_path(rig):
    """As in the JAX package: ``fused=True`` on a host array stages it
    chunk by chunk through the loop strategies (the hint-chained ring)."""
    _, loop_poses, _ = _port(rig, host=True)
    _, poses, _ = _port(rig, host=True, fused=True)
    assert np.array_equal(poses, loop_poses)


def test_unknown_ring_strategy_raises(rig):
    with pytest.raises(ValueError, match="ring strategy"):
        merge.register_sequence(torch.zeros((3, 1024, 3)),
                                torch.ones((3, 1024), dtype=torch.bool),
                                merge.MergeParams(**FAST), strategy="vmap")


def test_batched_nearest_one_reference_is_the_loop(rng):
    """Ragged E / M / N: each edge's plain result equals the single-edge
    plain version on that edge, bit for bit; the wrapper on the CPU takes
    it without a launch."""
    e, m, n = 3, 700, 1500
    q = torch.from_numpy(rng.normal(0, 50, (e, m, 3)).astype(np.float32))
    p = torch.from_numpy(rng.normal(0, 50, (e, n, 3)).astype(np.float32))
    valid = torch.from_numpy(rng.random((e, n)) > 0.2)
    valid[2] = False                           # one edge with no valid key
    kt, p2v = nn.key_table(p, valid)
    assert kt.shape == (e, 3, 2048) and p2v.shape == (e, 1, 2048)
    before = nn.nearest_one.launches
    d2, idx = nn.nearest_one(q, kt, p2v)
    assert nn.nearest_one.launches == before
    assert d2.shape == (e, m) and idx.shape == (e, m)
    for k in range(e):
        skt, sp2v = nn.key_table(p[k], valid[k])
        assert torch.equal(skt, kt[k]) and torch.equal(sp2v, p2v[k])
        rd2, ridx = nn.nearest_one_reference(q[k], skt, sp2v)
        assert torch.equal(d2[k].view(torch.int32), rd2.view(torch.int32))
        assert torch.equal(idx[k], ridx)
    assert torch.isinf(d2[2]).all() and (idx[2] == 0).all()
    with pytest.raises(ValueError, match="edge axis"):
        nn.nearest_one(q, kt[:2], p2v[:2])


def test_batched_icp_matches_per_edge(rng):
    """Three edges of a noisy rotated cloud, batched against per edge."""
    e, m = 3, 600
    src = rng.normal(0, 30, (e, m, 3)).astype(np.float32)
    dst = np.empty_like(src)
    nrm = rng.normal(0, 1, (e, m, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    for k in range(e):
        th = np.radians(2.0 + k)
        R = np.array([[np.cos(th), -np.sin(th), 0],
                      [np.sin(th), np.cos(th), 0], [0, 0, 1]], np.float32)
        dst[k] = src[k] @ R.T + np.float32(0.5 * k)
    sv = torch.from_numpy(rng.random((e, m)) > 0.1)
    dv = torch.from_numpy(rng.random((e, m)) > 0.1)
    S, D, N = (torch.from_numpy(a) for a in (src, dst, nrm))
    kw = dict(max_correspondence_distance=4.0, max_iterations=10,
              method="point_to_plane",
              schedule=tuple(float(4.0 ** (1 - i / 9)) for i in range(10)),
              warmup_subsample=4)
    batched = registration.icp(S, D, dst_normals=N, src_valid=sv,
                               dst_valid=dv, **kw)
    info = registration.information_matrix(S, D, batched.transformation, 4.0,
                                           src_valid=sv, dst_valid=dv)
    for k in range(e):
        one = registration.icp(S[k], D[k], dst_normals=N[k], src_valid=sv[k],
                               dst_valid=dv[k], **kw)
        np.testing.assert_allclose(batched.transformation[k].numpy(),
                                   one.transformation.numpy(), atol=1e-5)
        np.testing.assert_allclose(float(batched.fitness[k]),
                                   float(one.fitness), atol=1e-5)
        np.testing.assert_allclose(float(batched.inlier_rmse[k]),
                                   float(one.inlier_rmse), atol=1e-5)
        one_info = registration.information_matrix(
            S[k], D[k], batched.transformation[k], 4.0, src_valid=sv[k],
            dst_valid=dv[k])
        np.testing.assert_allclose(info[k].numpy(), one_info.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_batched_ransac_draws_each_edges_own_stream(rng):
    """The batched RANSAC takes one generator an edge and draws exactly
    what each edge's single run draws, so its per-edge winners match."""
    e, m = 2, 512
    src = torch.from_numpy(rng.normal(0, 30, (e, m, 3)).astype(np.float32))
    feat = torch.from_numpy(rng.random((e, m, 33)).astype(np.float32))
    dst = src + torch.tensor([1.0, -2.0, 0.5])
    val = torch.ones((e, m), dtype=torch.bool)
    gens = [merge.edge_generator(7, k, "cpu") for k in range(e)]
    res = registration.ransac_feature_registration(
        src, feat, dst, feat, distance_threshold=1.0, src_valid=val,
        dst_valid=val, num_iterations=2048, generator=gens)
    for k in range(e):
        one = registration.ransac_feature_registration(
            src[k], feat[k], dst[k], feat[k], distance_threshold=1.0,
            src_valid=val[k], dst_valid=val[k], num_iterations=2048,
            generator=merge.edge_generator(7, k, "cpu"))
        np.testing.assert_allclose(res.transformation[k].numpy(),
                                   one.transformation.numpy(), atol=1e-5)
        assert float(res.fitness[k]) == float(one.fitness)


def test_batched_feature_match_is_the_per_edge_match(rng):
    """``match_features`` over an edge axis (``knn`` with a leading batch
    axis: the same tiles, expansion and recompute, the products batched)
    against the single match edge by edge; bit-equal on the CPU."""
    e, m, n = 3, 1200, 2100
    src = torch.from_numpy(rng.random((e, m, 33)).astype(np.float32))
    dst = torch.from_numpy(rng.random((e, n, 33)).astype(np.float32))
    sv = torch.from_numpy(rng.random((e, m)) > 0.1)
    dv = torch.from_numpy(rng.random((e, n)) > 0.1)
    idx, ok = registration.match_features(src, dst, sv, dv)
    assert idx.shape == ok.shape == (e, m)
    for k in range(e):
        one_idx, one_ok = registration.match_features(src[k], dst[k], sv[k],
                                                      dv[k])
        assert torch.equal(idx[k], one_idx) and torch.equal(ok[k], one_ok)
