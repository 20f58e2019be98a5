"""Several cards in the port's serving tier: device lanes, sticky
sessions, the sharded bucket and device loss — the port's cases of
tests/test_serve_lanes.py, on host lanes.

The JAX package runs these on 8 forced host devices (tests/conftest.py);
the port's service gets ``lane_devices=HOST``, eight host devices
``torch.device("cpu", k)`` that the pool tells apart by label. Every host
tensor reports ``cpu``, so these tests cannot see a tensor left behind on
a lane's old device: the data movement is checked by walking the session's
state (``test_repin_moves_every_tensor_the_session_holds``) and, on the
card, only by a two-card run.

Tolerances: the sharded bucket's PLY equals the port's lane-pinned result
bit for bit and is within ``atol=1e-3`` of the JAX package's
``pipeline.reconstruct`` (as tests/test_serve_lanes.py holds JAX's); the
sharded solve's faces within 2% of the unsharded solve's; a re-pinned
session's PLY equals a never-moved one's byte for byte.
"""

import dataclasses
import gc
import io
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu_torch.config import (
    ProjectorConfig,
)
from structured_light_for_3d_model_replication_tpu_torch.models import (
    synthetic,
)
from structured_light_for_3d_model_replication_tpu_torch.serve import (
    DeviceLanePool,
    ReconstructionService,
    ServeConfig,
)
from structured_light_for_3d_model_replication_tpu_torch.serve.batcher import (
    BucketKey,
)
from structured_light_for_3d_model_replication_tpu_torch.utils import sanitize

PROJ = ProjectorConfig(width=64, height=32)     # 6+5 bits, 24 frames
H, W = 24, 40                                   # lane-pinned bucket
HB, WB = 32, 48                                 # sharded bucket
BATCH_SIZES = (1, 2)
N_LANES = 2
HOST = tuple(torch.device("cpu", k) for k in range(8))


def _bucket(h, w):
    return BucketKey(height=h, width=w, frames=PROJ.n_frames,
                     col_bits=PROJ.col_bits, row_bits=PROJ.row_bits)


def _pool(**kw):
    return DeviceLanePool(devices=HOST, **kw)


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
# Lane pool (pure routing logic)
# ---------------------------------------------------------------------------


def test_pool_spreads_lanes_round_robin_over_devices():
    pool = _pool(n_lanes=4)
    assert [ln.label for ln in pool.lanes] == [f"cpu:{i}" for i in range(4)]
    assert pool.multi_device
    # More lanes than devices wraps round-robin instead of failing.
    pool = _pool(n_lanes=3, max_devices=2)
    assert [ln.label for ln in pool.lanes] == ["cpu:0", "cpu:1", "cpu:0"]


def test_pool_single_device_routes_historical_keys():
    """A one-device pool produces the un-pinned program keys
    (device=None), so a single-worker service keeps its program set."""
    pool = _pool(n_lanes=1)
    assert not pool.multi_device
    key = pool.route(_bucket(H, W), 1, pool.lane(0))
    assert key.device is None and key.shards == 0
    assert key.label() == f"B1:{H}x{W}x{PROJ.n_frames}"


def test_pool_shard_threshold_and_divisibility():
    pool = _pool(n_lanes=2, shard_min_pixels=HB * WB, shard_devices=4)
    small = pool.route(_bucket(H, W), 2, pool.lane(1))
    assert small.device == "cpu:1" and small.shards == 0
    # At the threshold: one cross-card program keyed by the device SET.
    big = pool.route(_bucket(HB, WB), 2, pool.lane(1))
    assert big.shards == 4 and big.device is None
    assert big.span == ("cpu:0", "cpu:1", "cpu:2", "cpu:3")
    assert big.label().endswith("@mesh4[cpu:0+cpu:1+cpu:2+cpu:3]")
    assert [str(d) for d in pool.span_jax_devices(big.span)] == \
        ["cpu:0", "cpu:1", "cpu:2", "cpu:3"]
    mesh = pool.solve_mesh(_bucket(HB, WB))
    assert mesh.labels() == list(big.span)
    assert pool.solve_mesh(_bucket(HB, WB)) is mesh   # one per device set
    assert pool.solve_mesh(_bucket(H, W)) is None
    # Rows not divisible by the shard count: lane-pinned.
    odd = pool.route(_bucket(33, 64), 1, pool.lane(0))
    assert odd.shards == 0 and odd.device == "cpu:0"
    off = _pool(n_lanes=2)
    assert off.shards_for(_bucket(HB, WB)) == 0


def test_pool_sticky_session_assignment_least_loaded():
    pool = _pool(n_lanes=2)
    a = pool.assign_session("s-a")
    b = pool.assign_session("s-b")
    assert {a.index, b.index} == {0, 1}
    assert pool.assign_session("s-a") is a      # idempotent
    pool.release_session("s-a")
    c = pool.assign_session("s-c")              # freed slot reused
    assert c.index == a.index


# ---------------------------------------------------------------------------
# Integrated multi-lane service
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lane_stack():
    cam = synthetic.default_calibration(H, W, PROJ)
    stack, _ = synthetic.render_scan(synthetic.Scene(), *cam, H, W, PROJ)
    return stack


@pytest.fixture(scope="module")
def big_stack():
    cam = synthetic.default_calibration(HB, WB, PROJ)
    stack, _ = synthetic.render_scan(synthetic.Scene(), *cam, HB, WB, PROJ)
    return stack


@pytest.fixture(scope="module")
def service():
    from structured_light_for_3d_model_replication_tpu_torch.stream import (
        StreamParams,
    )

    cfg = ServeConfig(device="cpu", proj=PROJ, buckets=((H, W), (HB, WB)),
                      batch_sizes=BATCH_SIZES, linger_ms=5.0,
                      queue_depth=32, workers=N_LANES, mesh_depth=6,
                      shard_min_pixels=HB * WB, shard_devices=2,
                      stream=StreamParams(preview_depth=5))
    svc = ReconstructionService(cfg, lane_devices=HOST).start()
    yield svc
    svc.drain(timeout=15.0)


def _lane_counts(svc):
    return dict(svc.registry.snapshot().get("serve_lane_jobs_total", {}))


def test_warmup_covers_every_lane_and_the_sharded_program(service):
    labels = set(service._warmup_report)
    frames = PROJ.n_frames
    for b in BATCH_SIZES:
        for d in range(N_LANES):
            assert f"B{b}:{H}x{W}x{frames}@cpu:{d}" in labels
    # The big bucket: the sharded program only, labelled by its span.
    span = service.lanes.span_devices()
    assert span == ("cpu:0", "cpu:1")
    span_tag = "+".join(span)
    for b in BATCH_SIZES:
        assert f"B{b}:{HB}x{WB}x{frames}@mesh2[{span_tag}]" in labels
        for d in range(N_LANES):
            assert f"B{b}:{HB}x{WB}x{frames}@cpu:{d}" not in labels
    # Session warm-up ran once per distinct lane device.
    for d in range(N_LANES):
        assert f"session:{H}x{W}@cpu:{d}" in labels
    # stats() (what /healthz and cli diagnose carry) names the span.
    st = service.stats()["lanes"]
    assert st["span_devices"] == list(span) and st["shard_devices"] == 2


def test_jobs_complete_across_lanes_with_zero_recompiles(service,
                                                         lane_stack):
    before = service.cache.stats()
    jobs = [service.submit_array(lane_stack + np.uint8(1 + i))
            for i in range(12)]
    for j in jobs:
        assert j.wait(60.0), j.status_dict()
        assert j.status == "done", j.status_dict()
    after = service.cache.stats()
    assert after["misses"] == before["misses"], (before, after)
    counts = _lane_counts(service)
    assert sum(counts.values()) >= 12, counts
    assert all("device=" in k for k in counts)


def test_sticky_sessions_land_on_distinct_lanes(service, lane_stack):
    s1 = service.create_session({"covis": False})
    s2 = service.create_session({"covis": False})
    e1 = service.sessions.get(s1["session_id"])
    e2 = service.sessions.get(s2["session_id"])
    assert e1.lane is not None and e2.lane is not None
    assert e1.lane.index != e2.lane.index       # least-loaded spread
    assert e1.device == e1.lane.device          # built on its lane's card
    job = service.submit_session_stop(s1["session_id"], lane_stack)
    assert job.lane == e1.lane.index            # stop carries affinity
    assert job.wait(60.0) and job.status == "done", job.status_dict()
    assert e1.status_dict()["device_lane"] == e1.lane.label
    job2 = service.submit_session_stop(s2["session_id"], lane_stack)
    assert job2.lane == e2.lane.index
    assert job2.wait(60.0) and job2.status == "done", job2.status_dict()


def test_session_stop_is_compile_free_on_warm_lane(service, lane_stack):
    sid = service.create_session({"covis": False})["session_id"]
    entry = service.sessions.get(sid)
    assert entry.lane is not None
    before = service.cache.stats()
    with sanitize.no_compile_region("serve-lane-session-stop"):
        for i in (3, 9):
            job = service.submit_session_stop(sid, lane_stack + np.uint8(i))
            assert job.wait(60.0) and job.status == "done", \
                job.status_dict()
    assert service.cache.stats()["misses"] == before["misses"]


def test_sharded_bucket_dispatch_and_decode_parity(service, big_stack):
    """A big-bucket job rides the cross-card program: its PLY equals the
    port's one-device pipeline bit for bit, and the JAX package's
    ``pipeline.reconstruct`` within 1e-3."""
    import jax.numpy as jnp

    from structured_light_for_3d_model_replication_tpu.config import (
        ProjectorConfig as JProjectorConfig,
    )
    from structured_light_for_3d_model_replication_tpu.models import (
        pipeline as jpipeline,
    )
    from structured_light_for_3d_model_replication_tpu.serve.service import (
        synthetic_calib_provider as jcalib_provider,
    )
    from structured_light_for_3d_model_replication_tpu_torch.io.ply import (
        read_ply,
    )
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        pipeline,
    )
    from structured_light_for_3d_model_replication_tpu_torch.serve.service \
        import synthetic_calib_provider

    sharded = service.registry.counter("serve_sharded_batches_total")
    before = sharded.value
    job = service.submit_array(big_stack)
    assert job.wait(120.0) and job.status == "done", job.status_dict()
    assert sharded.value > before
    got = read_ply(io.BytesIO(job.result_bytes))

    calib = synthetic_calib_provider(PROJ, "cpu")(HB, WB)
    out = pipeline.reconstruct(big_stack, calib, PROJ.col_bits,
                               PROJ.row_bits, device="cpu")
    keep = out.valid.numpy()
    assert np.array_equal(got.points, out.points.numpy()[keep])
    assert np.array_equal(got.colors, out.colors.numpy()[keep])

    jproj = JProjectorConfig(width=PROJ.width, height=PROJ.height)
    jcal = jcalib_provider(jproj)(HB, WB)
    jout = jpipeline.reconstruct(jnp.asarray(big_stack), jcal,
                                 PROJ.col_bits, PROJ.row_bits)
    jkeep = np.asarray(jout.valid).astype(bool)
    want = np.asarray(jout.points)[jkeep]
    assert got.points.shape == want.shape
    np.testing.assert_allclose(got.points, want, atol=1e-3)


@pytest.mark.slow
def test_sharded_bucket_stl_solves_over_the_device_mesh(service,
                                                        big_stack):
    """STL postprocess of a sharded-bucket job: the Poisson solve runs on
    a card of the same span (``device_mesh``) and yields a watertight
    mesh."""
    job = service.submit_array(big_stack, result_format="stl")
    assert job.wait(180.0) and job.status == "done", job.status_dict()
    assert job.result_meta["faces"] > 0, job.result_meta


def test_sharded_bucket_stl_solves_on_one_card_of_the_span(
        service, big_stack, monkeypatch):
    """A sharded-bucket STL job's dense solve runs whole on one card of
    its span, not spread over the span's cards (slower at the serve
    tier's depths, PERF.md): the worker passes a one-member
    ``device_mesh``, this lane's card when the span holds it, else the
    span's first, and the job's mesh is the one-device mesh of its cloud
    face for face."""
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        meshing,
    )
    from structured_light_for_3d_model_replication_tpu_torch.parallel.mesh \
        import device_label

    real, calls = meshing.mesh_from_cloud, []

    def recorded(cloud, **kw):
        calls.append((cloud, kw))
        return real(cloud, **kw)

    monkeypatch.setattr(meshing, "mesh_from_cloud", recorded)
    job = service.submit_array(big_stack + np.uint8(2), result_format="stl")
    assert job.wait(180.0) and job.status == "done", job.status_dict()
    (cloud, kw), = calls
    span = service.lanes.span_devices()
    (member,) = kw["device_mesh"].space_members
    lane = device_label(kw["device"])
    assert device_label(member) == (lane if lane in span else span[0])
    plain = real(cloud, **dict(kw, device_mesh=None, device=member))
    assert job.result_meta["faces"] == len(plain.faces) > 0


def _sphere_cloud(n=4001):
    rng = np.random.default_rng(0)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return (v * 50.0 + np.asarray([0.0, 0.0, 500.0])).astype(np.float32)


def test_sharded_solve_pads_non_divisible_clouds():
    """As tests/test_serve_lanes.py: 4001 points with a two-member
    ``device_mesh`` (the JAX package pads them with a ``valid=False`` row
    to split them; the port cuts the grid's planes over the members), the
    faces within 2% of the JAX package's sharded solve on its host
    mesh."""
    from structured_light_for_3d_model_replication_tpu.io.ply import (
        PointCloud as JPointCloud,
    )
    from structured_light_for_3d_model_replication_tpu.models import (
        meshing as jmeshing,
    )
    from structured_light_for_3d_model_replication_tpu.parallel import (
        mesh as jmesh,
    )
    from structured_light_for_3d_model_replication_tpu_torch.io.ply import (
        PointCloud,
    )
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        meshing,
    )
    from structured_light_for_3d_model_replication_tpu_torch.parallel import (
        mesh as pmesh,
    )

    pts = _sphere_cloud()
    colors = np.full((len(pts), 3), 128, np.uint8)
    mesh = meshing.mesh_from_cloud(
        PointCloud(points=pts, colors=colors), depth=5, quantile_trim=0.0,
        device_mesh=pmesh.serve_space_mesh(2, devices=HOST), device="cpu")
    ref = jmeshing.mesh_from_cloud(
        JPointCloud(points=pts, colors=colors), depth=5, quantile_trim=0.0,
        device_mesh=jmesh.serve_space_mesh(2))
    assert len(mesh.faces) > 500
    assert abs(len(mesh.faces) - len(ref.faces)) <= 0.02 * len(ref.faces)


def test_padded_sharded_solve_depth5_matches_unsharded(monkeypatch):
    """The tier-1 case of the padded sharded solve: 4001 points, no member
    multiple, with a ``device_mesh`` of one, two and three host members at
    depth 5. One member is the plain solve on it, so its mesh equals the
    unsharded one bit for bit. Two and three members spread the solve
    over their slabs of planes, whose sums fold in member order: CG
    iterations within 1, χ and iso within 1e-5·max|χ| of the unsharded
    grid, faces within 0.5% (tests/test_torch_poisson_slabs.py's bounds).
    The grid is gathered on the caller's device when the mesh holds it,
    else on the first member."""
    from structured_light_for_3d_model_replication_tpu_torch.io.ply import (
        PointCloud,
    )
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        meshing,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        poisson,
    )
    from structured_light_for_3d_model_replication_tpu_torch.parallel import (
        mesh as pmesh,
    )

    real, solves = poisson.reconstruct, []

    def recorded(*args, **kw):
        grid, iters = real(*args, **dict(kw, return_iters=True))
        solves.append((grid, iters))
        return grid

    monkeypatch.setattr(meshing.poisson, "reconstruct", recorded)
    pts = _sphere_cloud()
    cloud = PointCloud(points=pts, colors=np.full((len(pts), 3), 128,
                                                  np.uint8))
    ref = meshing.mesh_from_cloud(cloud, depth=5, quantile_trim=0.0,
                                  device="cpu")
    ref_grid, ref_iters = solves.pop()
    scale = float(ref_grid.chi.abs().max())
    assert len(ref.faces) > 500
    for k in (1, 2, 3):
        m = pmesh.serve_space_mesh(k, devices=HOST[1:])
        assert meshing.solve_device(m, HOST[k]) == HOST[k]
        assert meshing.solve_device(m, HOST[0]) == HOST[1]
        mesh = meshing.mesh_from_cloud(cloud, depth=5, quantile_trim=0.0,
                                       device="cpu", device_mesh=m)
        grid, iters = solves.pop()
        if k == 1:
            assert np.array_equal(mesh.vertices, ref.vertices)
            assert np.array_equal(mesh.faces, ref.faces)
            continue
        assert abs(iters - ref_iters) <= 1
        assert float((grid.chi - ref_grid.chi).abs().max()) <= 1e-5 * scale
        assert abs(float(grid.iso) - float(ref_grid.iso)) <= 1e-5 * scale
        assert abs(len(mesh.faces) - len(ref.faces)) <= 0.005 * len(ref.faces)


# ---------------------------------------------------------------------------
# Device-loss tolerance: seeded chaos, lane health, re-pin
# ---------------------------------------------------------------------------


def test_device_fault_plan_env_roundtrip_and_determinism(monkeypatch):
    from structured_light_for_3d_model_replication_tpu_torch.hw import faults

    plan = faults.DeviceFaultPlan([
        faults.DeviceFaultRule(device="cpu:1", kind="device_lost",
                               after_launches=2, count=3),
        faults.DeviceFaultRule(device="cpu:2", kind="nan_output"),
    ])
    monkeypatch.setenv(faults.DEVICE_FAULTS_ENV, plan.to_env())
    loaded = faults.DeviceFaultPlan.from_env()
    assert [dataclasses.asdict(r) for r in loaded.rules] == \
        [dataclasses.asdict(r) for r in plan.rules]
    assert plan.fault_for("cpu:1", 1) is None
    assert plan.fault_for("cpu:1", 2).kind == "device_lost"
    assert plan.fault_for("cpu:1", 4).kind == "device_lost"
    assert plan.fault_for("cpu:1", 5) is None
    assert plan.fault_for("cpu:2", 999).kind == "nan_output"
    assert plan.fault_for("cpu:0", 0) is None
    inj = faults.DeviceFaultInjector(plan)
    assert inj.next_fault("cpu:1") is None
    assert inj.next_fault("cpu:1") is None
    assert inj.next_fault("cpu:1").kind == "device_lost"
    assert inj.first_fault_t() is not None
    assert [(d, i, k) for _, d, i, k in inj.injected] == \
        [("cpu:1", 2, "device_lost")]
    a = faults.DeviceFaultPlan.seeded(7, [f"cpu:{i}" for i in range(8)],
                                      p_dead=0.3)
    b = faults.DeviceFaultPlan.seeded(7, [f"cpu:{i}" for i in range(8)],
                                      p_dead=0.3)
    assert [r.device for r in a.rules] == [r.device for r in b.rules]


def test_device_loss_taxonomy_per_backend():
    from structured_light_for_3d_model_replication_tpu_torch.hw import faults

    assert faults.is_device_loss(faults.DeviceLostError("x"), backend="cpu")
    halted = RuntimeError("INTERNAL: Core halted unexpectedly")
    assert faults.is_device_loss(halted, backend="tpu")
    assert not faults.is_device_loss(halted, backend="cpu")
    # The port's default reads the failed launch's device; a host launch
    # does not read the TPU vocabulary.
    assert not faults.is_device_loss(halted, device=HOST[3])
    gone = RuntimeError("CUDA_ERROR_DEVICE_UNAVAILABLE: GPU is lost")
    assert faults.is_device_loss(gone, backend="gpu")
    assert faults.is_device_loss(gone, backend="cuda")
    assert faults.is_device_loss(gone, device=torch.device("cuda", 1))
    assert not faults.is_device_loss(gone, backend="tpu")
    for b in ("cpu", "tpu", "gpu"):
        assert faults.is_device_loss(
            RuntimeError("status: DEVICE_LOST"), backend=b)
        assert not faults.is_device_loss(
            RuntimeError("RESOURCE_EXHAUSTED: out of memory"), backend=b)
    assert faults.is_device_loss(halted, backend="weird-runtime")


def test_device_loss_env_extension(monkeypatch):
    from structured_light_for_3d_model_replication_tpu_torch.hw import faults

    wedged = RuntimeError("neuron watchdog: engine wedged")
    assert not faults.is_device_loss(wedged, backend="tpu")
    monkeypatch.setenv(faults.DEVICE_LOSS_PATTERNS_ENV,
                       '{"tpu": ["engine wedged"]}')
    assert faults.is_device_loss(wedged, backend="tpu")
    assert not faults.is_device_loss(wedged, backend="gpu")

    class VendorDriverDeath(RuntimeError):
        pass

    monkeypatch.setenv(
        faults.DEVICE_LOSS_PATTERNS_ENV,
        '{"gpu": {"types": ["VendorDriverDeath"], "patterns": []}}')
    assert faults.is_device_loss(VendorDriverDeath("opaque"), backend="gpu")
    assert not faults.is_device_loss(VendorDriverDeath("opaque"),
                                     backend="cpu")
    monkeypatch.setenv(faults.DEVICE_LOSS_PATTERNS_ENV,
                       "ring bus parity, fabric link down")
    assert faults.is_device_loss(RuntimeError("Ring bus PARITY error"),
                                 backend="cpu")
    monkeypatch.setenv(faults.DEVICE_LOSS_PATTERNS_ENV, "[1, 2]")
    assert not faults.is_device_loss(RuntimeError("benign"), backend="cpu")


def test_lane_health_hysteresis_and_dead_callback():
    from structured_light_for_3d_model_replication_tpu_torch.serve import (
        lanes,
    )

    pool = _pool(n_lanes=2)
    deaths: list = []
    pool.on_device_dead = deaths.append
    assert pool.note_launch_failure("cpu:1") == lanes.LANE_HEALTHY
    assert pool.lane_alive(1)
    pool.note_launch_ok("cpu:1")
    assert pool.note_launch_failure("cpu:1") == lanes.LANE_HEALTHY
    assert pool.note_launch_failure("cpu:1") == lanes.LANE_SUSPECT
    assert pool.note_launch_failure("cpu:1") == lanes.LANE_DEAD
    assert deaths == ["cpu:1"]
    assert not pool.lane_alive(1) and pool.lane_alive(0)
    assert pool.dead_devices() == ["cpu:1"]
    pool.note_launch_ok("cpu:1")
    assert pool.device_state("cpu:1") == lanes.LANE_DEAD
    assert not pool.mark_device_dead("cpu:1")
    assert pool.revive_device("cpu:1")
    assert pool.device_state("cpu:1") == lanes.LANE_HEALTHY
    pool.mark_device_dead("cpu:0", reason="test")
    assert pool.assign_session("s-x").label == "cpu:1"


def test_shard_degrade_ladder():
    pool = _pool(n_lanes=8, shard_min_pixels=1, shard_devices=8)
    big = _bucket(32, 48)
    assert pool.shards_for(big) == 8
    assert pool.span_devices() == tuple(sorted(f"cpu:{i}" for i in range(8)))
    pool.mark_device_dead("cpu:0", reason="test")
    assert pool.effective_shard_devices() == 4
    span = pool.span_devices()
    assert "cpu:0" not in span and len(span) == 4
    assert pool.shards_for(big) == 4
    key = pool.route(big, 1, pool.lane(1))
    assert key.shards == 4 and key.span == span and key.device is None
    for d in ("cpu:1", "cpu:2", "cpu:3", "cpu:4"):
        pool.mark_device_dead(d, reason="test")
    assert pool.effective_shard_devices() == 2
    assert all(m not in pool.span_devices()
               for m in ("cpu:0", "cpu:1", "cpu:2", "cpu:3", "cpu:4"))
    pool.mark_device_dead("cpu:5", reason="test")
    pool.mark_device_dead("cpu:6", reason="test")
    assert pool.effective_shard_devices() == 0
    assert pool.shards_for(big) == 0
    key = pool.route(big, 1, pool.lane(7))
    assert key.shards == 0 and key.device == "cpu:7"
    pool.revive_device("cpu:0")
    assert pool.effective_shard_devices() == 2
    assert pool.span_devices() == ("cpu:0", "cpu:7")


def test_watchdog_per_device_budget_and_escalation():
    """One dead card burning its restart budget does not disable the
    watchdog for healthy cards; a spent budget escalates to dead."""
    from structured_light_for_3d_model_replication_tpu_torch.serve.governor \
        import GovernorParams, OverloadGovernor
    from structured_light_for_3d_model_replication_tpu_torch.serve.jobs import (
        AdmissionQueue,
    )
    from structured_light_for_3d_model_replication_tpu_torch.utils import (
        trace,
    )

    def wedged_worker(name, label):
        return types.SimpleNamespace(
            name=name, lane=types.SimpleNamespace(label=label),
            alive=True, abandoned=False, last_beat=-1e9)

    params = GovernorParams(watchdog_interval_s=0.02, wedge_timeout_s=0.01,
                            watchdog_max_restarts=2)
    gov = OverloadGovernor(params, AdmissionQueue(max_depth=4),
                           trace.MetricsRegistry())
    workers = [wedged_worker("w-sick", "cpu:1")]
    escalated: list = []
    lock = threading.Lock()

    def restart(w):
        repl = wedged_worker(w.name + "r", w.lane.label)
        with lock:
            workers[workers.index(w)] = repl
        return repl

    gov.start_watchdog(lambda: list(workers), restart,
                       escalate_fn=lambda w: escalated.append(w.lane.label))
    try:
        deadline = time.monotonic() + 5.0
        while not escalated and time.monotonic() < deadline:
            time.sleep(0.02)
        assert escalated == ["cpu:1"]
        assert gov.stats()["worker_restarts_by_device"]["cpu:1"] == 2
        with lock:
            workers.append(wedged_worker("w-healthy", "cpu:0"))
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if gov.stats()["worker_restarts_by_device"].get("cpu:0"):
                break
            time.sleep(0.02)
        assert gov.stats()["worker_restarts_by_device"].get("cpu:0")
        gov.reset_restart_budget("cpu:1")
        assert "cpu:1" not in gov.stats()["worker_restarts_by_device"]
    finally:
        gov.stop_watchdog()


def test_watchdog_lane_swap_keeps_device_and_cache_counters(service,
                                                            lane_stack):
    wedged = service.workers[1]
    lane_before = wedged.lane
    before = service.cache.stats()
    repl = service._restart_worker(wedged)
    assert repl is service.workers[1]
    assert repl.lane is lane_before and repl.alive
    mid = service.cache.stats()
    assert mid["misses"] == before["misses"] and mid["hits"] == before["hits"]
    jobs = [service.submit_array(lane_stack + np.uint8(40 + i))
            for i in range(4)]
    for j in jobs:
        assert j.wait(60.0) and j.status == "done", j.status_dict()
    after = service.cache.stats()
    assert after["misses"] == mid["misses"], (mid, after)
    assert after["hits"] > mid["hits"]


# ---------------------------------------------------------------------------
# Integrated device chaos: dead card mid-session, NaN containment, revive
# ---------------------------------------------------------------------------


def _chaos_service(**over):
    from structured_light_for_3d_model_replication_tpu_torch.stream import (
        StreamParams,
    )

    base = dict(device="cpu", proj=PROJ, buckets=((H, W),), batch_sizes=(1,),
                linger_ms=5.0, queue_depth=16, workers=2, devices=2,
                mesh_depth=6, content_cache=False,
                stream=StreamParams(preview_depth=5),
                device_probe_interval_s=120.0)
    base.update(over)
    return ReconstructionService(ServeConfig(**base), lane_devices=HOST)


def _arm(monkeypatch, *rules):
    from structured_light_for_3d_model_replication_tpu_torch.hw import faults

    plan = faults.DeviceFaultPlan(list(rules))
    monkeypatch.setenv(faults.DEVICE_FAULTS_ENV, plan.to_env())


def _stop(svc, sid, stack, timeout=60.0):
    job = svc.submit_session_stop(sid, stack)
    assert job.wait(timeout), job.status_dict()
    return job


def _pinned(svc, stack):
    from structured_light_for_3d_model_replication_tpu_torch.serve.jobs import (
        Job,
    )

    cfg = svc.config
    job = Job(stack=stack, col_bits=cfg.proj.col_bits,
              row_bits=cfg.proj.row_bits, decode_cfg=cfg.decode_cfg,
              tri_cfg=cfg.tri_cfg, result_format="ply")
    job.lane = 1
    job.on_terminal = svc._on_terminal
    svc.queue.submit(job)
    return job


def test_device_lost_mid_session_repins_and_finalizes_bitwise(
        monkeypatch, lane_stack):
    """A card that starts refusing launches mid-scan is escalated to dead,
    its sticky session moves to the surviving lane with its state, no
    acknowledged stop is lost, and the finalize on the adopted lane equals
    a never-faulted session's byte for byte."""
    from structured_light_for_3d_model_replication_tpu_torch.hw import faults
    from structured_light_for_3d_model_replication_tpu_torch.serve import (
        lanes,
    )

    _arm(monkeypatch, faults.DeviceFaultRule(
        device="cpu:1", kind="device_lost", after_launches=2))
    # The session warm-up builds no program (the module's service
    # fixture checks that it runs on every lane), so it is left out here.
    svc = _chaos_service(warmup_sessions=False).start()
    try:
        s_ok = svc.create_session({"covis": False})["session_id"]
        s_victim = svc.create_session({"covis": False})["session_id"]
        victim = svc.sessions.get(s_victim)
        assert victim.lane.label == "cpu:1"
        assert victim.device == HOST[1]
        stacks = [lane_stack + np.uint8(1 + i) for i in range(5)]
        jobs = [_stop(svc, s_victim, s) for s in stacks]
        assert all(j.status == "done" for j in jobs), \
            [j.status_dict() for j in jobs]
        assert sum(j.launch_retries for j in jobs) >= 3
        assert svc.lanes.device_state("cpu:1") == lanes.LANE_DEAD
        assert victim.lane.label == "cpu:0"
        # The session's own device followed it (the state it builds new
        # work on moved with it).
        assert victim.device == HOST[0]
        snap = svc.registry.snapshot()
        assert sum(snap.get("serve_device_dead_total", {}).values()) == 1
        assert sum(snap.get("serve_lane_repins_total", {}).values()) >= 1
        state = dict(snap.get("serve_lane_state", {}))
        assert any("cpu:1" in k and v == 2 for k, v in state.items()), state
        assert svc.queue.max_depth == 8
        ready = svc.readiness()
        assert ready["ready"] and ready.get("degraded")
        assert ready["devices_dead"] == ["cpu:1"]
        assert svc.lanes.stats()["devices_dead"] == ["cpu:1"]
        before = svc.cache.stats()
        with sanitize.no_compile_region("lane-chaos-adopted-stop"):
            post = _stop(svc, s_victim, lane_stack + np.uint8(9))
        assert post.status == "done" and post.lane == victim.lane.index
        assert svc.cache.stats()["misses"] == before["misses"]
        for s in stacks + [lane_stack + np.uint8(9)]:
            _stop(svc, s_ok, s)
        got = svc.finalize_session(s_victim, result_format="ply")
        ref = svc.finalize_session(s_ok, result_format="ply")
        assert got.wait(120.0) and ref.wait(120.0)
        assert got.status == "done" and ref.status == "done"
        assert len(got.result_bytes) > 0
        assert got.result_bytes == ref.result_bytes
    finally:
        svc.abort()


def test_nan_output_contained_without_tripping_breaker(monkeypatch,
                                                       lane_stack):
    from structured_light_for_3d_model_replication_tpu_torch.hw import faults
    from structured_light_for_3d_model_replication_tpu_torch.serve import (
        lanes,
    )

    monkeypatch.setenv("SL_SANITIZE", "1")
    _arm(monkeypatch, faults.DeviceFaultRule(
        device="cpu:1", kind="nan_output", count=2))
    svc = _chaos_service(warmup_sessions=False).start()
    try:
        j1 = _pinned(svc, lane_stack + np.uint8(1))
        j2 = _pinned(svc, lane_stack + np.uint8(2))
        for j in (j1, j2):
            assert j.wait(60.0) and j.status == "done", j.status_dict()
            assert j.launch_retries == 1
        assert svc.lanes.device_state("cpu:1") == lanes.LANE_SUSPECT
        assert svc.governor.breaker_open() is None
        snap = svc.registry.snapshot()
        assert sum(snap.get("serve_breaker_trips_total", {}).values()) == 0
        j3 = _pinned(svc, lane_stack + np.uint8(3))
        assert j3.wait(60.0) and j3.status == "done", j3.status_dict()
        assert j3.launch_retries == 0
        assert svc.lanes.device_state("cpu:1") == lanes.LANE_HEALTHY
    finally:
        svc.abort()


def test_probe_revives_device_after_transient_loss(monkeypatch,
                                                   lane_stack):
    from structured_light_for_3d_model_replication_tpu_torch.hw import faults
    from structured_light_for_3d_model_replication_tpu_torch.serve import (
        lanes,
    )

    _arm(monkeypatch, faults.DeviceFaultRule(
        device="cpu:1", kind="device_lost", count=4))
    svc = _chaos_service(
        warmup_sessions=False, device_probe_interval_s=0.2,
        device_probe_backoff_max_s=0.5).start()
    try:
        jobs = [_pinned(svc, lane_stack + np.uint8(1 + i)) for i in range(3)]
        for j in jobs:
            assert j.wait(60.0) and j.status == "done", j.status_dict()
        assert svc.lanes.device_state("cpu:1") == lanes.LANE_DEAD
        assert svc.queue.max_depth == 8
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and \
                svc.lanes.device_state("cpu:1") != lanes.LANE_HEALTHY:
            time.sleep(0.05)
        assert svc.lanes.device_state("cpu:1") == lanes.LANE_HEALTHY
        assert svc.queue.max_depth == 16
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and not any(
                w.alive and w.lane is not None and w.lane.label == "cpu:1"
                for w in svc.workers):
            time.sleep(0.05)
        assert any(w.alive and w.lane is not None
                   and w.lane.label == "cpu:1" for w in svc.workers)
        j = _pinned(svc, lane_stack + np.uint8(7))
        assert j.wait(60.0) and j.status == "done", j.status_dict()
        assert j.launch_retries == 0
    finally:
        svc.abort()


# ---------------------------------------------------------------------------
# The sharded tier's honesty: set-keyed spans, probe-convict, rebalancing
# ---------------------------------------------------------------------------


def test_sharded_fault_streak_fires_probe_callback():
    pool = _pool(n_lanes=2, shard_min_pixels=1, shard_devices=4)
    fired: list = []
    pool.on_span_suspect = fired.append
    span = pool.span_devices()
    assert len(span) == 4
    assert pool.note_sharded_failure(span, reason="DeviceLostError") == 1
    assert not fired
    pool.note_sharded_ok(span)
    assert pool.note_sharded_failure(span) == 1
    pool.note_sharded_failure(span)
    assert fired == [span]
    assert pool.note_sharded_failure(span) == 1
    assert fired == [span]


def test_rebalance_hysteresis_defers_flapping_device():
    pool = _pool(n_lanes=2, rebalance_flap_window_s=0.2)
    home = pool.assign_session("s-v")
    assert home.label == "cpu:0"
    pool.mark_device_dead("cpu:0", reason="test")
    assert pool.repin_sessions("cpu:0")["s-v"].label == "cpu:1"
    assert pool.revive_device("cpu:0")
    assert pool.rebalance_sessions("cpu:0")["s-v"].label == "cpu:0"
    pool.mark_device_dead("cpu:0", reason="test")
    assert pool.repin_sessions("cpu:0")["s-v"].label == "cpu:1"
    assert pool.revive_device("cpu:0")
    assert pool.rebalance_sessions("cpu:0") == {}
    assert pool.assign_session("s-v").label == "cpu:1"
    time.sleep(0.25)
    assert pool.rebalance_sessions("cpu:0")["s-v"].label == "cpu:0"


def test_sharded_fault_probe_convicts_first_device_and_reforms_span(
        monkeypatch, big_stack):
    """The first card in enumeration order dies under a sharded-only
    load: the probe convicts cpu:0 and only cpu:0, the span re-forms
    2-wide from the live set, is warmed off the hot path, and no
    acknowledged job is lost."""
    from structured_light_for_3d_model_replication_tpu_torch.hw import faults
    from structured_light_for_3d_model_replication_tpu_torch.serve import (
        lanes,
    )

    _arm(monkeypatch, faults.DeviceFaultRule(device="cpu:0",
                                             kind="device_lost"))
    svc = _chaos_service(
        buckets=((HB, WB),), queue_depth=16, workers=2, devices=4,
        shard_min_pixels=HB * WB, shard_devices=4,
        warmup_sessions=False).start()
    try:
        assert svc.lanes.span_devices() == \
            ("cpu:0", "cpu:1", "cpu:2", "cpu:3")
        jobs = [svc.submit_array(big_stack + np.uint8(1 + i))
                for i in range(4)]
        for j in jobs:
            assert j.wait(120.0) and j.status == "done", j.status_dict()
        assert svc.lanes.device_state("cpu:0") == lanes.LANE_DEAD
        for d in ("cpu:1", "cpu:2", "cpu:3"):
            assert svc.lanes.device_state(d) == lanes.LANE_HEALTHY
        span = svc.lanes.span_devices()
        assert len(span) == 2 and "cpu:0" not in span
        assert svc.lanes.effective_shard_devices() == 2
        snap = svc.registry.snapshot()
        assert sum(snap.get("serve_sharded_span_faults_total",
                            {}).values()) >= 2
        assert sum(snap.get("serve_sharded_span_probes_total",
                            {}).values()) >= 1
        assert sum(snap.get("serve_device_dead_total", {}).values()) == 1
        st = svc.lanes.stats()
        assert st["span_devices"] == list(span)
        assert st["shard_devices"] == 2
        assert st["device_health"]["cpu:0"]["state"] == lanes.LANE_DEAD
        assert st["device_health"]["cpu:0"]["dead_since_s"] >= 0.0
        assert st["device_health"]["cpu:1"]["dead_since_s"] is None
        before = svc.cache.stats()
        j = svc.submit_array(big_stack + np.uint8(9))
        assert j.wait(120.0) and j.status == "done", j.status_dict()
        assert svc.cache.stats()["misses"] == before["misses"]
    finally:
        svc.abort()


def test_probe_revival_rebalances_sessions_and_finalizes_bitwise(
        monkeypatch, lane_stack):
    from structured_light_for_3d_model_replication_tpu_torch.hw import faults
    from structured_light_for_3d_model_replication_tpu_torch.serve import (
        lanes,
    )

    _arm(monkeypatch, faults.DeviceFaultRule(
        device="cpu:1", kind="device_lost", count=4))
    svc = _chaos_service(
        warmup_sessions=False, device_probe_interval_s=0.2,
        device_probe_backoff_max_s=0.5).start()
    try:
        s_ok = svc.create_session({"covis": False})["session_id"]
        s_victim = svc.create_session({"covis": False})["session_id"]
        victim = svc.sessions.get(s_victim)
        assert victim.lane.label == "cpu:1"
        stacks = [lane_stack + np.uint8(1 + i) for i in range(3)]
        jobs = [_stop(svc, s_victim, s) for s in stacks]
        assert all(j.status == "done" for j in jobs), \
            [j.status_dict() for j in jobs]
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and victim.lane.label != "cpu:1":
            time.sleep(0.05)
        assert svc.lanes.device_state("cpu:1") == lanes.LANE_HEALTHY
        assert victim.lane.label == "cpu:1"
        assert victim.device == HOST[1]
        assert victim.status_dict()["lane_moves"] == 2
        snap = svc.registry.snapshot()
        assert sum(snap.get("serve_lane_repins_total", {}).values()) >= 1
        assert sum(snap.get("serve_lane_rebalances_total",
                            {}).values()) == 1
        st = svc.lanes.stats()
        assert st["revives_total"] == 1
        assert st["device_health"]["cpu:1"]["revives"] == 1
        assert st["device_health"]["cpu:1"]["dead_since_s"] is None
        before = svc.cache.stats()
        post = _stop(svc, s_victim, lane_stack + np.uint8(7))
        assert post.status == "done" and post.lane == victim.lane.index
        assert svc.cache.stats()["misses"] == before["misses"]
        for s in stacks + [lane_stack + np.uint8(7)]:
            _stop(svc, s_ok, s)
        got = svc.finalize_session(s_victim, result_format="ply")
        ref = svc.finalize_session(s_ok, result_format="ply")
        assert got.wait(120.0) and ref.wait(120.0)
        assert got.status == "done" and ref.status == "done"
        assert len(got.result_bytes) > 0
        assert got.result_bytes == ref.result_bytes
    finally:
        svc.abort()


def _reachable_tensors(root):
    """Every tensor reachable from ``root`` through the garbage
    collector's referents (modules, classes and functions not entered)."""
    seen, out, todo = set(), [], [root]
    skip = (type, types.ModuleType, types.FunctionType,
            types.BuiltinFunctionType, types.MethodType)
    while todo:
        obj = todo.pop()
        if id(obj) in seen or isinstance(obj, skip):
            continue
        seen.add(id(obj))
        if isinstance(obj, torch.Tensor):
            out.append(obj)
            continue
        if isinstance(obj, (np.ndarray, str, bytes)):
            continue
        todo.extend(gc.get_referents(obj))
    return out


def test_repin_moves_every_tensor_the_session_holds(lane_stack):
    """Cross-card ``repin`` walks the session's state. On the host every
    lane's tensors report ``cpu``, so the walk is checked by sending a
    session with state in every part (the model, retained preps, the
    preview grid, the registration) to the ``meta`` device: afterwards
    no tensor reachable from the session is left on the host."""
    from structured_light_for_3d_model_replication_tpu_torch.serve import (
        sessions as sessions_mod,
    )
    from structured_light_for_3d_model_replication_tpu_torch.stream import (
        IncrementalSession,
        StreamParams,
    )
    from structured_light_for_3d_model_replication_tpu_torch.serve.service \
        import synthetic_calib_provider

    calib = synthetic_calib_provider(PROJ, "cpu")(H, W)
    sess = IncrementalSession(calib, PROJ.col_bits, PROJ.row_bits,
                              params=StreamParams(preview_depth=5,
                                                  covis=False),
                              device=HOST[1])
    for i in range(3):
        sess.add_stop(lane_stack + np.uint8(1 + i))
    before = [t for t in _reachable_tensors(sess) if t.device.type == "cpu"]
    assert len(before) > 5
    entry = sessions_mod.ServeSession(
        "s", sess, H * W, lane=types.SimpleNamespace(device=HOST[1]))
    meta = torch.device("meta")
    entry.repin(types.SimpleNamespace(device=meta, label="meta:0"))
    assert sess.device == meta
    left = [tuple(t.shape) for t in _reachable_tensors(sess)
            if t.device.type == "cpu"]
    assert not left, left

