"""The port's streaming slice — ``stream/``, ``ops/posegraph.py``,
``health.py``, ``utils/overlap.py`` and the Poisson warm starts — against
the JAX package's on the same numpy inputs, on the CPU, and the port's
session against the port's batch ring.

Tolerances:
* ``posegraph.optimize``/``build_360_graph`` on a seeded 6-node ring with a
  loop edge: poses to 1e-4 (float32 LM steps, the same Jacobian);
* ``consensus_step_np``, ``ring_edges``, ``gate_edges``: numpy copies, equal
  to 1e-12;
* ``mesh_from_cloud_async``: bit-equal to ``mesh_from_cloud`` (on the CPU
  every sum runs in one order);
* the dense warm start: fewer CG iterations on the second, unchanged
  preview (≤ 2); the sparse warm start: ``warm_start_blocks > 0``, fewer
  iterations from a previous band grid;
* the covisibility gate on identical state (point sets, fused-model voxels,
  poses): the JAX package's overlaps and decisions exactly;
* a 4-stop small-rig session per lane: the first preview after stop 1, a
  duplicate stop skipped, poses against the JAX session within 0.5° (the
  RANSAC streams differ), and the port's session against the port's batch
  ``method="posegraph"`` to 1e-3 (the JAX package's bar,
  tests/test_stream.py): the same per-edge generators, so on the CPU they
  agree to the bit;
* a 4-stop ``"tsdf"`` session with ``expected_stops=4``: bit-equal to the
  session without it; with ``tsdf_carve_steps=24`` against the JAX
  package's same session by outcome (poses within 0.5°, preview faces
  within 2%), its preview weights never above the uncarved session's and
  its final mesh the uncarved one's bit for bit;
* a 4-stop ``representation="splat"`` session at the JAX package's tiny
  splat settings: stride, frame count and splat count equal to the JAX
  session's, intrinsics to 1e-6, and the two renders of one orbit view
  at ≥ 25 dB PSNR of each other (the poses differ within 0.5° by the RANSAC
  streams, and the fits sum in another order).
"""

import dataclasses
import os
import threading
import time

import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu import health as jhealth
from structured_light_for_3d_model_replication_tpu.models import merge as jmerge
from structured_light_for_3d_model_replication_tpu.ops import (
    posegraph as jposegraph,
)
from structured_light_for_3d_model_replication_tpu.ops import (
    triangulate as jtri,
)
from structured_light_for_3d_model_replication_tpu.ops.registration import (
    exp_se3 as jexp_se3,
)
from structured_light_for_3d_model_replication_tpu.stream import (
    IncrementalSession as JSession,
)
from structured_light_for_3d_model_replication_tpu.stream import (
    StreamParams as JStreamParams,
)
from structured_light_for_3d_model_replication_tpu_torch import health
from structured_light_for_3d_model_replication_tpu_torch.config import (
    ProjectorConfig,
)
from structured_light_for_3d_model_replication_tpu_torch.io import ply
from structured_light_for_3d_model_replication_tpu_torch.models import (
    merge,
    meshing,
    scan360,
    synthetic,
)
from structured_light_for_3d_model_replication_tpu_torch.ops import (
    poisson,
    poisson_sparse,
    posegraph,
)
from structured_light_for_3d_model_replication_tpu_torch.ops.triangulate import (
    make_calibration,
)
from structured_light_for_3d_model_replication_tpu_torch.stream import (
    IncrementalSession,
    PreviewMesher,
    StreamParams,
    voxel_overlap,
    warm_session_programs,
)
from structured_light_for_3d_model_replication_tpu_torch.utils.overlap import (
    PipelinedTask,
)

from .conftest import CAM_H, CAM_W, SMALL_PROJ


@pytest.fixture(autouse=True, scope="module")
def _share_cores_with_workers():
    """Give this module's PyTorch ops the worker's share of the cores (see
    tests/test_torch_meshing.py)."""
    n = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, n // workers))
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Pose graph and health
# ---------------------------------------------------------------------------


def _ring(n=6, seed=0):
    rng = np.random.default_rng(seed)
    Ts = []
    for _ in range(n - 1):
        w = np.array([0.0, 0.26, 0.0]) + rng.normal(0, 0.01, 3)
        t = rng.normal(0, 5, 3)
        Ts.append(np.asarray(jexp_se3(np.float32(w), np.float32(t))))
    Ts = np.stack(Ts).astype(np.float32)
    loop = np.linalg.inv(np.linalg.multi_dot(list(Ts))).astype(np.float32)
    loop[:3, 3] += 3.0                          # drift for the LM to spread
    A = rng.normal(size=(n, 6, 6))
    info = (A @ A.transpose(0, 2, 1) + 6 * np.eye(6)).astype(np.float32)
    return Ts, loop, info


@pytest.mark.parametrize("with_loop", [True, False])
def test_posegraph_matches_jax(with_loop):
    Ts, loop, info = _ring()
    n = Ts.shape[0] + 1
    jloop = (loop, info[n - 1]) if with_loop else (None, None)
    jg = jposegraph.build_360_graph(Ts, info[:n - 1], *jloop)
    t = torch.from_numpy
    tg = posegraph.build_360_graph(
        t(Ts), t(info[:n - 1]), *(None if a is None else t(a)
                                  for a in jloop))
    np.testing.assert_array_equal(tg.edge_src.numpy(),
                                  np.asarray(jg.edge_src))
    np.testing.assert_array_equal(tg.edge_dst.numpy(),
                                  np.asarray(jg.edge_dst))
    np.testing.assert_allclose(tg.poses.numpy(), np.asarray(jg.poses),
                               atol=1e-4)
    ref = np.asarray(jposegraph.optimize(jg, iterations=50))
    got = posegraph.optimize(tg, iterations=50).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    if with_loop:                     # the loop edge moved the poses
        assert np.abs(ref - np.asarray(jg.poses)).max() > 0.1


def test_consensus_and_gates_match_jax():
    Ts, _, info = _ring(9, 1)
    Ts64 = Ts.astype(np.float64)
    for step in (None, 15.0, 90.0):
        np.testing.assert_allclose(health.consensus_step_np(Ts64, step),
                                   jhealth.consensus_step_np(Ts64, step),
                                   atol=1e-12)
    assert health.consensus_step_np(np.zeros((0, 4, 4))) is None
    labels = [0, 1, 3, 4, 5, 6, 7, 9]
    edges = health.ring_edges(labels, loop=True, span=12)
    assert edges == jhealth.ring_edges(labels, loop=True, span=12)
    fit = np.array([0.9, 0.05, 0.8, 0.9, np.nan, 0.9, 0.7, 0.1])
    rmse = np.linspace(0.5, 2.0, 8)
    gates = health.QualityGates(min_edge_fitness=0.2, max_edge_rmse=1.8)
    jgates = jhealth.QualityGates(min_edge_fitness=0.2, max_edge_rmse=1.8)
    report, jreport = health.ScanHealthReport(), jhealth.ScanHealthReport()
    got = health.gate_edges(edges, Ts, fit, rmse, info[:8], gates,
                            step_deg=15.0, report=report)
    ref = jhealth.gate_edges(edges, Ts, fit, rmse, info[:8], jgates,
                             step_deg=15.0, report=jreport)
    np.testing.assert_allclose(got[0], ref[0], atol=1e-12)
    np.testing.assert_allclose(got[1], ref[1], atol=1e-12)
    assert [repr(e.to_dict()) for e in got[2]] == \
        [repr(e.to_dict()) for e in ref[2]]          # NaN fitness included
    assert report.to_dict()["rejected_edges"] == 3


# ---------------------------------------------------------------------------
# Pipelined worker
# ---------------------------------------------------------------------------


def test_pipelined_task_result_timings_and_reraise():
    gate = threading.Event()

    def work(a, b=1):
        gate.wait(5.0)
        return a + b

    task = PipelinedTask(work, 2, b=3, name="t")
    assert not task.done()
    with pytest.raises(TimeoutError):
        task.result(timeout=0.01)
    gate.set()
    assert task.result(timeout=5.0) == 5 and task.done()
    t = task.timings()
    assert 0.0 <= t["started_s"] <= t["ended_s"]

    def boom():
        raise KeyError("worker failure")

    bad = PipelinedTask(boom, name="bad")
    with pytest.raises(KeyError, match="worker failure"):
        bad.result(timeout=5.0)
    assert not bad._thread.is_alive()


def _sphere_cloud(n=2000, seed=4):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    return ply.PointCloud(points=(u * 30 + [0, 0, 500]).astype(np.float32),
                          normals=u.astype(np.float32),
                          colors=((u * .5 + .5) * 255).astype(np.uint8))


@pytest.mark.parametrize("representation", ["tsdf", "poisson"])
def test_mesh_from_cloud_async_is_bit_equal(representation):
    kw = dict(representation=representation, depth=6, device="cpu")
    seq = meshing.mesh_from_cloud(_sphere_cloud(), **kw)
    task = meshing.mesh_from_cloud_async(_sphere_cloud(), task_name="t",
                                         **kw)
    asy = task.result(timeout=120)
    assert len(seq.faces) > 100
    np.testing.assert_array_equal(asy.vertices, seq.vertices)
    np.testing.assert_array_equal(asy.faces, seq.faces)
    bad = meshing.mesh_from_cloud_async(_sphere_cloud(), device="cpu",
                                        representation="nope")
    with pytest.raises(ValueError, match="representation"):
        bad.result(timeout=60)


# ---------------------------------------------------------------------------
# Poisson warm starts
# ---------------------------------------------------------------------------


def test_preview_warm_start_fewer_cg_iters():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(2048, 3)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    valid = torch.ones(2048, dtype=torch.bool)
    pm = PreviewMesher(points=1024, depth=4, cg_iters=200)
    pm(torch.from_numpy(pts), valid)
    cold = pm.last_cg_iters
    pm(torch.from_numpy(pts), valid)
    warm = pm.last_cg_iters
    assert cold is not None and cold > 3
    assert warm < cold and warm <= 2
    with pytest.raises(ValueError, match="depth"):
        PreviewMesher(depth=9)
    with pytest.raises(ValueError, match="does not match"):
        poisson.reconstruct(torch.from_numpy(pts), torch.from_numpy(pts),
                            depth=4, x0=torch.zeros((8, 8, 8)))


def test_sparse_warm_starts():
    """A dense grid of the same cloud at the coarse resolution warm-starts
    the coarse solve (every band block covered, fewer coarse
    iterations); a previous band grid seeds the band, and an identical
    re-solve then stops at once. Two small spheres far apart keep the
    depth-9 band small."""
    rng = np.random.default_rng(1)
    u = rng.normal(size=(2000, 3)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    centers = np.float32([[0.0, 10.0, 500.0], [200.0, 210.0, 700.0]])
    pts = torch.from_numpy(centers[np.arange(2000) % 2] + 25.0 * u)
    nrm = torch.from_numpy(u)
    kw = dict(depth=9, max_blocks=4096, cg_iters=30, with_stats=True)
    dense = poisson.reconstruct(pts, nrm, depth=7, cg_iters=300)
    cold_grid, nb, cold = poisson_sparse.reconstruct_sparse(pts, nrm, **kw)
    _, _, warm_dense = poisson_sparse.reconstruct_sparse(pts, nrm, x0=dense,
                                                         **kw)
    assert cold["warm_start_blocks"] == 0
    assert warm_dense["warm_start_blocks"] == nb > 0
    assert warm_dense["coarse_iters_used"] < cold["coarse_iters_used"]
    _, _, warm = poisson_sparse.reconstruct_sparse(pts, nrm, x0=cold_grid,
                                                   **kw)
    assert warm["warm_start_blocks"] == nb
    assert warm["cg_iters_used"] < cold["cg_iters_used"]
    with pytest.raises(TypeError, match="x0"):
        poisson_sparse.reconstruct_sparse(pts, nrm, x0=object(), **kw)


# ---------------------------------------------------------------------------
# Sessions on the small rig
# ---------------------------------------------------------------------------

SPHERES = ((0.0, 10.0, 500.0, 80.0, 0.9), (60.0, -40.0, 460.0, 35.0, 0.7),
           (-70.0, 40.0, 530.0, 30.0, 0.8), (20.0, 70.0, 440.0, 25.0, 0.75))
FAST = dict(voxel_size=6.0, ransac_iterations=2048, icp_iterations=20,
            fpfh_max_nn=32, normals_k=12, max_points=2048,
            posegraph_iterations=20, step_deg=10.0, final_max_points=4096)
STREAM = dict(method="posegraph", view_cap=8192, preview_points=2048,
              preview_depth=5, final_depth=6, model_cap=32_768, window=3,
              tsdf_grid_depth=6, tsdf_max_bricks=1024)


def _angle(R):
    return np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))


@pytest.fixture(scope="module")
def rig():
    proj = ProjectorConfig(width=SMALL_PROJ.width, height=SMALL_PROJ.height,
                           brightness=SMALL_PROJ.brightness)
    mats = synthetic.default_calibration(CAM_H, CAM_W, proj)
    scene = synthetic.Scene(wall_z=None, spheres=tuple(
        synthetic.Sphere((x, y, z), r, a) for x, y, z, r, a in SPHERES))
    stacks = np.stack([s for s, _ in synthetic.render_turntable_scans(
        scene, 4, 10.0, *mats, CAM_H, CAM_W, proj)])
    calib = make_calibration(*mats, CAM_H, CAM_W, proj.width, proj.height,
                             device="cpu")
    return stacks, calib, mats


@pytest.fixture(scope="module")
def batch_posegraph(rig):
    stacks, calib, _ = rig
    return scan360.scan_stacks_to_cloud(
        stacks, calib, SMALL_PROJ.col_bits, SMALL_PROJ.row_bits,
        params=scan360.Scan360Params(merge=merge.MergeParams(**FAST),
                                     method="posegraph", view_cap=8192),
        with_stats=True, device="cpu")


@pytest.fixture(scope="module")
def jax_session_poses(rig):
    stacks, _, mats = rig
    jcal = jtri.make_calibration(*mats, CAM_H, CAM_W, SMALL_PROJ.width,
                                 SMALL_PROJ.height)
    sp = JStreamParams(merge=jmerge.MergeParams(**FAST), preview_every=0,
                       **{k: v for k, v in STREAM.items()
                          if not k.startswith("preview")})
    sess = JSession(jcal, SMALL_PROJ.col_bits, SMALL_PROJ.row_bits,
                    params=sp)
    for k in range(4):
        sess.add_stop(stacks[k])
    return sess.finalize(mesh=False).poses


@pytest.fixture(scope="module", params=["tsdf", "archival", "poisson"])
def lane(request, rig):
    stacks, calib, _ = rig
    sp = StreamParams(merge=merge.MergeParams(**FAST),
                      representation=request.param, **STREAM)
    sess = IncrementalSession(calib, SMALL_PROJ.col_bits,
                              SMALL_PROJ.row_bits, params=sp,
                              device="cpu")
    results = [sess.add_stop(stacks[k]) for k in range(4)]
    metas = [dict(sess.preview_meta)]
    fin = sess.finalize(mesh=True)
    return request.param, sess, results, metas, fin


def test_session_lane(lane, batch_posegraph, jax_session_poses):
    rep, sess, results, metas, fin = lane
    assert all(r.fused for r in results), [r.to_dict() for r in results]
    assert results[0].preview and sess.preview_meta["stops_fused"] == 4
    assert len(sess.preview.faces) > 0
    colored = sess.preview.vertex_colors is not None
    assert colored == (rep != "poisson")
    # The port's session against the port's batch pose-graph ring.
    merged_b, poses_b, stats_b = batch_posegraph
    np.testing.assert_allclose(fin.poses, poses_b, atol=1e-3)
    assert abs(len(fin.cloud) - len(merged_b)) <= 0.02 * len(merged_b) + 2
    assert len(stats_b["edges"]) == 4 and stats_b["edges"][3]["src"] == 0
    # Against the JAX package's session, by outcome.
    for i in range(4):
        a, ja = _angle(fin.poses[i][:3, :3]), _angle(jax_session_poses[i][:3,
                                                                         :3])
        assert abs(a - ja) <= 0.5 and abs(a - 10.0 * i) <= 3.0, (i, a, ja)
    assert fin.stats["overlap"]["overlapped"] is not None
    assert len(fin.mesh.faces) > 100
    assert (fin.mesh.vertex_colors is not None) == (rep == "tsdf")
    if rep == "poisson":
        assert sess.previewer.last_cg_iters is not None


def test_first_preview_and_duplicate_skip(rig):
    stacks, calib, _ = rig
    sp = StreamParams(merge=merge.MergeParams(**FAST),
                      **dict(STREAM, method="sequential"))
    sess = IncrementalSession(calib, SMALL_PROJ.col_bits,
                              SMALL_PROJ.row_bits, params=sp, device="cpu")
    first = sess.add_stop(stacks[0])
    assert first.fused and first.preview
    assert sess.preview_meta["stops_fused"] == 1 and \
        sess.preview_meta["stop"] == 0
    assert sess.preview.vertex_colors is not None
    assert sess.preview_meta["integrate_s"] > 0.0
    t0 = time.monotonic()
    dup = sess.add_stop(stacks[0] + np.uint8(1))
    assert not dup.fused and dup.reason == "skipped_duplicate"
    assert dup.overlap is not None and dup.overlap > 0.98
    assert sess.stops_fused == 1 and sess.stops_skipped == 1
    assert time.monotonic() - t0 < 5.0
    assert sess.status_dict()["skipped"] == {"1": "skipped_duplicate"}
    with pytest.raises(ValueError, match="increasing"):
        sess.add_stop(stacks[1], stop=0)
    with pytest.raises(health.StopQualityError, match="at least 2"):
        sess.finalize()


@pytest.fixture(scope="module")
def tsdf_sessions(rig):
    """The port's 4-stop ``"tsdf"`` session plain, with free-space carving
    (``tsdf_carve_steps=24``) and with ``expected_stops=4``: (session,
    per-stop preview faces, finalize result) each."""
    stacks, calib, _ = rig
    out = {}
    for name, extra in (("plain", {}), ("carved", {"tsdf_carve_steps": 24}),
                        ("expected", {"expected_stops": 4})):
        sp = StreamParams(merge=merge.MergeParams(**FAST),
                          representation="tsdf", **STREAM, **extra)
        sess = IncrementalSession(calib, SMALL_PROJ.col_bits,
                                  SMALL_PROJ.row_bits, params=sp,
                                  device="cpu")
        faces = []
        for k in range(4):
            assert sess.add_stop(stacks[k]).fused
            faces.append(len(sess.preview.faces))
        out[name] = (sess, faces, sess.finalize(mesh=True))
    return out


def test_expected_stops_changes_nothing(tsdf_sessions):
    """The JAX package's key-schedule hint: here each edge seeds its own
    generator, so a session with ``expected_stops=4`` is the session
    without it, bit for bit (poses, live poses, cloud, previews, mesh)."""
    a, fa_, fin_a = tsdf_sessions["plain"]
    b, fb_, fin_b = tsdf_sessions["expected"]
    assert fa_ == fb_
    assert np.array_equal(a.live_poses(), b.live_poses())
    assert a.live_poses().shape == (4, 4, 4)
    assert np.array_equal(fin_a.poses, fin_b.poses)
    assert np.array_equal(fin_a.cloud.points, fin_b.cloud.points)
    assert np.array_equal(fin_a.cloud.colors, fin_b.cloud.colors)
    assert np.array_equal(fin_a.mesh.vertices, fin_b.mesh.vertices)
    assert np.array_equal(fin_a.mesh.faces, fin_b.mesh.faces)


def test_carved_tsdf_session_matches_jax(rig, tsdf_sessions):
    """``tsdf_carve_steps=24`` against the JAX package's same 4-stop
    session, by outcome as test_session_lane (poses within 0.5°, the RANSAC
    streams differ), plus: carving reaches the previews only — it decays
    or resets preview voxels (weights never grow) and the final mesh,
    re-fused from the merged cloud, is the uncarved session's bit for bit
    — and the carved previews' face counts within 2% of the JAX
    session's."""
    stacks, _, mats = rig
    plain, _, fin_p = tsdf_sessions["plain"]
    carved, faces, fin_c = tsdf_sessions["carved"]
    jcal = jtri.make_calibration(*mats, CAM_H, CAM_W, SMALL_PROJ.width,
                                 SMALL_PROJ.height)
    jsp = JStreamParams(merge=jmerge.MergeParams(**FAST),
                        representation="tsdf", tsdf_carve_steps=24, **STREAM)
    jsess = JSession(jcal, SMALL_PROJ.col_bits, SMALL_PROJ.row_bits,
                     params=jsp)
    jfaces = []
    for k in range(4):
        assert jsess.add_stop(stacks[k]).fused
        jfaces.append(len(jsess.preview.faces))
    jfin = jsess.finalize(mesh=True)
    for i in range(4):
        a = _angle(fin_c.poses[i][:3, :3])
        ja = _angle(jfin.poses[i][:3, :3])
        assert abs(a - ja) <= 0.5, (i, a, ja)
    for f, jf in zip(faces, jfaces):
        assert f > 0 and abs(f - jf) <= 0.02 * jf, (faces, jfaces)
    assert carved.preview.vertex_colors is not None
    w_plain = plain.previewer.volume.state.weight
    w_carved = carved.previewer.volume.state.weight
    assert bool((w_carved <= w_plain).all())
    assert int(((w_plain > 0) & (w_carved == 0)).sum()) > 0
    assert np.array_equal(fin_c.mesh.faces, fin_p.mesh.faces)
    assert np.array_equal(fin_c.mesh.vertices, fin_p.mesh.vertices)


def test_session_parameter_checks(rig):
    _, calib, _ = rig
    with pytest.raises(ValueError, match="method"):
        IncrementalSession(calib, 8, 7, params=StreamParams(method="nope"),
                           device="cpu")
    # The splat lane is ported: its session takes the appearance previewer.
    from structured_light_for_3d_model_replication_tpu_torch.splat import (
        SplatPreviewMesher,
    )

    splat = IncrementalSession(calib, 8, 7,
                               params=StreamParams(representation="splat"),
                               device="cpu")
    assert isinstance(splat.previewer, SplatPreviewMesher)
    # The serve replica's session warm-up is ported: it runs the session
    # lane once on three synthetic stops, on the device asked for.
    warm = warm_session_programs(
        StreamParams(merge=merge.MergeParams(**FAST), **STREAM),
        4096, SMALL_PROJ.col_bits, SMALL_PROJ.row_bits, device="cpu")
    assert warm["stops"] == 3 and warm["representation"] == "tsdf"
    # The batch stream (bench config 2b) is ported: it needs two stops.
    with pytest.raises(ValueError, match="at least 2 stops"):
        scan360.scan_stream_to_cloud(iter([]), calib, 8, 7, device="cpu")
    sp = dataclasses.replace(StreamParams(), representation="voxels")
    with pytest.raises(ValueError, match="representation"):
        IncrementalSession(calib, 8, 7, params=sp, device="cpu")


def test_voxel_overlap_measure():
    from structured_light_for_3d_model_replication_tpu_torch.stream.session \
        import _voxel_keys

    a = np.array([[0.1, 0.1, 0.1], [5.1, 0.1, 0.1], [0.1, 5.1, 0.1]],
                 np.float32)
    occ = _voxel_keys(a, 1.0)
    assert voxel_overlap(a, occ, 1.0) == 1.0
    b = a + np.float32([10.0, 0, 0])
    assert voxel_overlap(b, occ, 1.0) == 0.0
    assert voxel_overlap(np.vstack([a[:2], b[:2]]), occ, 1.0) == 0.5
    assert voxel_overlap(np.zeros((0, 3), np.float32), occ, 1.0) == 0.0


# ---------------------------------------------------------------------------
# The covisibility gate against the JAX package's, on identical state
# ---------------------------------------------------------------------------

GATE_VOXEL = 6.0            # covis_voxel_scale 2 × the headline's 3 mm voxel


def _turn(deg: float) -> np.ndarray:
    """Pose of a stop ``deg`` around the turntable in the stop-0 frame (the
    inverse of ``synthetic.rotated_scene``'s rotation about the pivot)."""
    th = np.deg2rad(deg)
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                  [-np.sin(th), 0, np.cos(th)]]).T
    pivot = np.array([0.0, 0.0, 500.0])
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, pivot - R @ pivot
    return T


def _gate_pair():
    """A JAX and a port session with the headline's gate settings."""
    mats = synthetic.default_calibration(CAM_H, CAM_W, SMALL_PROJ)
    kw = dict(covis=True, preview_every=0, representation="poisson")
    js = JSession(jtri.make_calibration(*mats, CAM_H, CAM_W, SMALL_PROJ.width,
                                        SMALL_PROJ.height),
                  SMALL_PROJ.col_bits, SMALL_PROJ.row_bits,
                  params=JStreamParams(merge=jmerge.MergeParams(
                      voxel_size=3.0, step_deg=15.0), **kw))
    ts = IncrementalSession(
        make_calibration(*mats, CAM_H, CAM_W, SMALL_PROJ.width,
                         SMALL_PROJ.height, device="cpu"),
        SMALL_PROJ.col_bits, SMALL_PROJ.row_bits,
        params=StreamParams(merge=merge.MergeParams(voxel_size=3.0,
                                                    step_deg=15.0), **kw),
        device="cpu")
    return js, ts


def _set_gate_state(sess, labels, poses, consensus, model_keys, prev_keys):
    sess._labels = list(labels)
    sess._poses = [np.asarray(p, np.float64) for p in poses]
    sess._consensus = consensus
    sess._model_voxels = model_keys
    sess._prev_cam_voxels = prev_keys


def _bump_ring_points(h=270, w=480, n=24, step=15.0, m_reg=8192):
    """The registration view of each stop of the headline bump scene: lit
    object points (camera frame), ray-cast at an (h, w) camera with the
    headline projector, thinned to ``m_reg`` points by a uniform stride."""
    proj = ProjectorConfig()

    def bump(az_deg, y, r):
        az = np.radians(az_deg)
        return synthetic.Sphere(
            (90.0 * np.sin(az), y, 500.0 + 90.0 * np.cos(az)), r, 0.75)

    scene = synthetic.Scene(wall_z=None, spheres=(
        synthetic.Sphere((0.0, 10.0, 500.0), 80.0, 0.9),
        bump(0, -40, 32), bump(60, 30, 26), bump(130, -10, 30),
        bump(200, 55, 24), bump(270, -55, 28), bump(320, 20, 22)))
    mats = synthetic.default_calibration(h, w, proj)
    out = []
    for k in range(n):
        gt = synthetic.FrameShader(synthetic.rotated_scene(scene, k * step),
                                   *mats, h, w, proj).ground_truth
        pts = gt["points"][gt["object_mask"] & gt["lit_mask"]]
        if len(pts) > m_reg:
            pts = pts[np.linspace(0, len(pts) - 1, m_reg).astype(np.int64)]
        out.append(pts.astype(np.float32))
    return out


@pytest.mark.parametrize("case", ["below", "at", "above", "ring_tail"])
def test_covis_gate_matches_jax(case):
    """The port's ``_covis_overlap`` gives the JAX package's overlaps and
    decisions on the same point sets and fused-model voxels: at 994, 995 and
    996 of 1000 voxels covered (the 0.995 model threshold), and stop by stop
    over the headline's 24 × 15° bump ring with exact poses, where the model
    overlap climbs through 0.995 at the ring's tail."""
    from structured_light_for_3d_model_replication_tpu.stream.session import (
        _voxel_keys as jkeys,
    )
    from structured_light_for_3d_model_replication_tpu_torch.stream.session \
        import _voxel_keys

    js, ts = _gate_pair()
    step = _turn(15.0)

    def both(label, reg, labels, model, prev):
        for s in (js, ts):
            _set_gate_state(s, labels, [_turn(15.0 * j) for j in labels],
                            step, model, prev)
        a, b = js._covis_overlap(label, reg), ts._covis_overlap(label, reg)
        assert a == b, (case, label, a, b)
        return b

    if case != "ring_tail":
        covered = {"below": 994, "at": 995, "above": 996}[case]
        rng = np.random.default_rng(7)
        cells = rng.choice(40 ** 3, 1000, replace=False)
        centres = (np.stack(np.unravel_index(cells, (40, 40, 40)), 1)
                   - 20 + 0.5) * GATE_VOXEL + np.array([0.0, 0.0, 500.0])
        pred = _turn(15.0 * 5)
        # Camera-frame points whose predicted positions are those centres.
        reg = ((centres - pred[:3, 3]) @ pred[:3, :3]).astype(np.float32)
        model = _voxel_keys(centres[:covered], GATE_VOXEL)
        np.testing.assert_array_equal(model, jkeys(centres[:covered],
                                                   GATE_VOXEL))
        got = both(5, reg, range(5), model, np.empty(0, np.int64))
        if case == "below":
            assert got is None
        else:
            assert got == ("skipped_covisible",
                           {"at": 0.995, "above": 0.996}[case])
        return

    # The session's sequence: a fused stop joins the model, a skipped one
    # does not; the duplicate test compares with the last fused stop.
    pts = _bump_ring_points()
    labels = [0]
    model = _voxel_keys(pts[0], GATE_VOXEL)
    decisions = {}
    for k in range(1, 24):
        pose = _turn(15.0 * k)
        cov = voxel_overlap(pts[k] @ pose[:3, :3].T + pose[:3, 3], model,
                            GATE_VOXEL)
        got = both(k, pts[k], labels, model,
                   _voxel_keys(pts[labels[-1]], GATE_VOXEL))
        decisions[k] = (round(cov, 5), None if got is None else got[0])
        if got is None:
            labels.append(k)
            model = np.union1d(model, _voxel_keys(
                pts[k] @ pose[:3, :3].T + pose[:3, 3], GATE_VOXEL))
    skipped = [k for k, (_, d) in decisions.items() if d is not None]
    assert skipped and all(decisions[k][1] == "skipped_covisible"
                           and decisions[k][0] >= 0.995 for k in skipped)
    assert min(skipped) >= 20, decisions          # only the ring's tail
    assert 0.98 <= decisions[min(skipped) - 1][0] < 0.995, decisions


# JAX's tiny splat lane (tests/test_stream.py's service settings).
SPLAT = dict(representation="splat", preview_every=0, splat_cap=2048,
             splat_fit_iters=4, splat_fit_pixels=960,
             splat_render_sizes=((96, 72),))


def test_splat_session_matches_jax(rig):
    """A tiny ``representation="splat"`` session on the 4-stop rig, in the
    port and in the JAX package: both fuse the four stops, buffer four
    frames at the same fit resolution, seed the same number of splats, and
    their renders from one orbit view agree to ≥ 25 dB PSNR (the poses
    differ by the RANSAC streams, within 0.5°, and the fit sums in another
    order). The port's final mesh is the coloured TSDF one."""
    from structured_light_for_3d_model_replication_tpu.splat.fit import (
        psnr as jpsnr,
    )

    stacks, calib, mats = rig
    jcal = jtri.make_calibration(*mats, CAM_H, CAM_W, SMALL_PROJ.width,
                                 SMALL_PROJ.height)
    jsess = JSession(jcal, SMALL_PROJ.col_bits, SMALL_PROJ.row_bits,
                     params=JStreamParams(merge=jmerge.MergeParams(**FAST),
                                          **STREAM, **SPLAT))
    sess = IncrementalSession(calib, SMALL_PROJ.col_bits,
                              SMALL_PROJ.row_bits,
                              params=StreamParams(
                                  merge=merge.MergeParams(**FAST), **STREAM,
                                  **SPLAT), device="cpu")
    for k in range(4):
        assert jsess.add_stop(stacks[k]).fused
        assert sess.add_stop(stacks[k]).fused
    jm, m = jsess._mesher, sess.previewer
    assert m.stride == jm.stride and m.frame_shape == jm.frame_shape
    assert len(m._frames) == len(jm._frames) == 4
    np.testing.assert_allclose(m.intrinsics, jm.intrinsics, rtol=1e-6)
    assert m.render_image(30.0, 20.0) is not None
    scene, jscene = m.ensure_scene(), jm.ensure_scene()
    assert scene.n_splats == jscene.n_splats > 500
    assert scene.fit_stats["fit_iters"] == 4
    assert not m.scene_stale and m.stats()["frames_seen"] == 4
    img = m.render_image(30.0, 20.0)
    jimg = jm.render_image(30.0, 20.0)
    assert img.shape == jimg.shape == (72, 96, 3)
    quality = jpsnr(img / 255.0, jimg / 255.0)
    assert quality >= 25.0, quality
    data, meta = m.render_png(30.0, 20.0)
    from structured_light_for_3d_model_replication_tpu_torch.io.png import (
        decode_png,
    )

    assert np.array_equal(decode_png(data), img) and meta["splats"] > 500
    fin = sess.finalize(mesh=True, overlap=False)
    assert len(fin.mesh.faces) > 100 and fin.mesh.vertex_colors is not None
