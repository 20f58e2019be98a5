"""Durable serving: the port's journal, crash recovery, content cache and
circuit breaker against the JAX package's on the same sequences, on
tests/test_durability.py's rig (``PROJ`` 64×32, camera 24×40, the soak
smoke's small-rig session params), on the CPU.

What is compared: the journal's live state after the same ops (equal);
across an in-process crash and ``start(recover_from=True)``, every job's
status and ``result_meta`` point count, the live state before and after
recovery, the content-cache hits across the restart (equal between the
packages); the port's recovered session's finalize bit for bit against
its uninterrupted run (the two packages' sessions agree to
tests/test_torch_stream.py's tolerance, not bit for bit); the breaker's
admissions and refusals (equal). Every wait has its
own bound.
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu import serve as jserve
from structured_light_for_3d_model_replication_tpu.config import (
    ProjectorConfig as JProjectorConfig,
)
from structured_light_for_3d_model_replication_tpu.models import (
    merge as jmerge,
)
from structured_light_for_3d_model_replication_tpu.models import (
    synthetic as jsynthetic,
)
from structured_light_for_3d_model_replication_tpu.serve.service import (
    synthetic_calib_provider as jsynthetic_calib_provider,
)
from structured_light_for_3d_model_replication_tpu.stream import (
    StreamParams as JStreamParams,
)
from structured_light_for_3d_model_replication_tpu.utils import (
    trace as jtrace,
)
from structured_light_for_3d_model_replication_tpu_torch import serve
from structured_light_for_3d_model_replication_tpu_torch.config import (
    ProjectorConfig,
)
from structured_light_for_3d_model_replication_tpu_torch.models import merge
from structured_light_for_3d_model_replication_tpu_torch.ops.triangulate import (
    calibration_from_numpy,
)
from structured_light_for_3d_model_replication_tpu_torch.stream import (
    StreamParams,
)
from structured_light_for_3d_model_replication_tpu_torch.utils import trace

PROJ = ProjectorConfig(width=64, height=32)
JPROJ = JProjectorConfig(width=64, height=32)
H, W = 24, 40
WAIT_S = 120.0
#: scripts/soak_smoke.py's small-rig session params, previews off (they
#: are not compared here, and their first programs are most of the JAX
#: session's cost on the CPU).
STREAM = dict(method="posegraph", view_cap=1024, preview_points=1024,
              preview_depth=4, final_depth=5, model_cap=8192, window=3,
              representation="poisson", preview_every=0)
MERGE = dict(voxel_size=4.0, ransac_iterations=512, icp_iterations=8,
             fpfh_max_nn=24, normals_k=8, max_points=1024,
             posegraph_iterations=10, step_deg=12.0)


@pytest.fixture(autouse=True, scope="module")
def _share_cores_with_workers():
    """Give this module's PyTorch ops the worker's share of the cores (see
    tests/test_torch_meshing.py)."""
    n = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, n // workers))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def serve_stack():
    cam = jsynthetic.default_calibration(H, W, JPROJ)
    stack, _ = jsynthetic.render_scan(jsynthetic.Scene(), *cam, H, W, JPROJ)
    return stack


@pytest.fixture(scope="module")
def serve_ring():
    """tests/test_durability.py's four turntable views."""
    cam = jsynthetic.default_calibration(H, W, JPROJ)
    scene = jsynthetic.Scene(
        wall_z=None,
        spheres=(jsynthetic.Sphere((0.0, 2.0, 500.0), 80.0, 0.9),
                 jsynthetic.Sphere((55.0, -30.0, 460.0), 35.0, 0.7),
                 jsynthetic.Sphere((-60.0, 35.0, 530.0), 30.0, 0.8)))
    scans = jsynthetic.render_turntable_scans(
        scene, n_stops=4, degrees_per_stop=12.0, cam_K=cam[0],
        proj_K=cam[1], R=cam[2], T=cam[3], cam_height=H, cam_width=W,
        proj=JPROJ)
    return [s for s, _ in scans]


def _carried(h, w, _memo={}):
    """The JAX service's synthetic calibration, carried into the port."""
    if (h, w) not in _memo:
        jcal = jsynthetic_calib_provider(JPROJ)(h, w)
        _memo[(h, w)] = calibration_from_numpy(
            {k: np.asarray(v) for k, v in jcal._asdict().items()},
            device="cpu")
    return _memo[(h, w)]


def _service(pkg, store_dir=None):
    """A one-worker service of ``pkg`` ("port" or "jax") on the rig."""
    if pkg == "port":
        stream = dataclasses.replace(StreamParams(),
                                     merge=merge.MergeParams(**MERGE),
                                     **STREAM)
        cfg = serve.ServeConfig(
            device="cpu", proj=PROJ, buckets=((H, W),), batch_sizes=(1, 2),
            linger_ms=5.0, queue_depth=16, workers=1, store_dir=store_dir,
            stream=stream, warmup_sessions=False)
        return serve.ReconstructionService(cfg, calib_provider=_carried)
    stream = dataclasses.replace(JStreamParams(),
                                 merge=jmerge.MergeParams(**MERGE), **STREAM)
    cfg = jserve.ServeConfig(
        proj=JPROJ, buckets=((H, W),), batch_sizes=(1, 2), linger_ms=5.0,
        queue_depth=16, workers=1, store_dir=store_dir, stream=stream,
        warmup_sessions=False)
    return jserve.ReconstructionService(cfg)


def _live(state) -> dict:
    """A journal's live state in comparable form (paths relative)."""
    return {"jobs": [(j.job_id, j.result_format, j.priority,
                      os.path.basename(j.stack_path), j.content_key)
                     for j in state.jobs],
            "sessions": [(s.session_id, s.scan_id, s.options,
                          [os.path.basename(p) for p in s.stop_paths])
                         for s in state.sessions]}


def test_journal_roundtrip_matches_jax(tmp_path):
    """The same ops through both JournalStores leave the same live state;
    either package's reader reads the other's journal."""
    out = {}
    for name, mod in (("port", serve), ("jax", jserve)):
        d = str(tmp_path / name)
        s = mod.JournalStore(d)
        rel = s.put_stack("j1", np.arange(24, dtype=np.uint8)
                          .reshape(2, 3, 4))
        s.append({"op": "job", "job_id": "j1", "stack": rel,
                  "result_format": "stl", "priority": 2,
                  "deadline_s": None, "content_key": "k1"})
        s.append({"op": "job", "job_id": "j2",
                  "stack": s.put_stack("j2", np.zeros((2, 3, 4), np.uint8)),
                  "result_format": "ply", "priority": 1,
                  "deadline_s": None, "content_key": "k2"})
        s.append({"op": "session", "session_id": "s1",
                  "scan_id": "serve-s1", "options": {"preview_every": 2}})
        rel2 = s.put_stack("s1-a", np.ones((2, 3, 4), np.uint8))
        s.append({"op": "stop", "session_id": "s1", "stack": rel2})
        s.append({"op": "job_done", "job_id": "j2", "status": "done"})
        s.close()
        out[name] = d
    for reader in (serve.read_live_state, jserve.read_live_state):
        got = _live(reader(out["port"]))
        assert got == _live(reader(out["jax"]))
        assert [j[0] for j in got["jobs"]] == ["j1"]
        assert len(got["sessions"]) == 1 and len(got["sessions"][0][3]) == 1
    # Reopened: the stack reads back; terminal + session_end empty it.
    s2 = serve.JournalStore(out["port"])
    back = s2.load_stack(serve.read_live_state(out["port"]).jobs[0]
                         .stack_path)
    assert np.array_equal(back, np.arange(24, dtype=np.uint8)
                          .reshape(2, 3, 4))
    s2.append({"op": "job_done", "job_id": "j1", "status": "done"})
    s2.append({"op": "session_end", "session_id": "s1",
               "reason": "deleted"})
    s2.close()
    assert serve.read_live_state(out["port"]).empty


def _uninterrupted(serve_ring) -> bytes:
    """The port's session over the whole ring, no crash: its finalize."""
    ref = _service("port").start()
    sid = ref.create_session({})["session_id"]
    for s in serve_ring:
        assert ref.submit_session_stop(sid, s).wait(WAIT_S)
    out = ref.finalize_session(sid, "ply").result_bytes
    assert ref.drain(timeout=WAIT_S)
    return out


def _crash_and_recover(pkg, store_dir, serve_stack, serve_ring):
    """tests/test_durability.py's crash sequence on ``pkg``; returns what
    the two packages are compared on, and the recovered finalize bytes."""
    svc = _service(pkg, store_dir).start()
    done = svc.submit_array(serve_stack)
    assert done.wait(WAIT_S) and done.status == "done"
    sid = svc.create_session({})["session_id"]
    for s in serve_ring[:2]:
        assert svc.submit_session_stop(sid, s).wait(WAIT_S)
    for w in svc.workers:
        w.abort()
        w.join(5.0)
        assert not w.alive
    queued = svc.submit_array(serve_stack + np.uint8(7))
    assert queued.status == "queued"
    svc.abort()
    crashed = _live((serve if pkg == "port" else jserve)
                    .read_live_state(store_dir))

    svc2 = _service(pkg, store_dir).start(recover_from=True)
    j2 = svc2.get_job(queued.job_id)
    assert j2 is not None and j2.recovered
    assert j2.wait(WAIT_S) and j2.status == "done", j2.status_dict()
    dup = svc2.submit_array(serve_stack)
    stops = svc2.sessions.get(sid).session.stops_fused
    for s in serve_ring[2:]:
        assert svc2.submit_session_stop(sid, s).wait(WAIT_S)
    fin = svc2.finalize_session(sid, "ply")
    svc2.sessions.delete(sid)
    assert svc2.drain(timeout=WAIT_S)
    after = (serve if pkg == "port" else jserve).read_live_state(store_dir)
    outcome = {
        "done": (done.status, done.result_meta["points"]),
        "crashed_jobs": len(crashed["jobs"]),
        "crashed_stops": [len(s[3]) for s in crashed["sessions"]],
        "recovered": (j2.status, j2.result_meta["points"]),
        "dup": (dup.status, dup.result_meta["content_cache_hit"],
                dup.result_meta["points"]),
        "session_stops_recovered": stops,
        "finalize": fin.status,
        "clean": after.empty}
    return outcome, fin.result_bytes


def test_crash_recover_matches_jax(tmp_path, serve_stack, serve_ring):
    port, p_fin = _crash_and_recover(
        "port", str(tmp_path / "port"), serve_stack, serve_ring)
    jax_, _ = _crash_and_recover(
        "jax", str(tmp_path / "jax"), serve_stack, serve_ring)
    assert port == jax_
    assert port["dup"][:2] == ("done", True) and port["clean"]
    assert port["crashed_jobs"] == 1 and port["crashed_stops"] == [2]
    # The recovered session finalizes bit for bit as an uninterrupted run
    # (the JAX package's own tests/test_durability.py holds its side).
    assert p_fin == _uninterrupted(serve_ring) and p_fin.startswith(b"ply")


def test_breaker_opens_and_recovers_half_open_as_in_jax():
    """The governor is host code: the same worker outcomes give the same
    admissions and refusals in both packages."""
    class _Queue:
        max_depth = 10

        def depth(self):
            return 0

        def retry_hint(self):
            return 0.5

    trail = {}
    for name, mod, tr in (("port", serve, trace), ("jax", jserve, jtrace)):
        params = mod.GovernorParams(breaker_window=8, breaker_min_samples=4,
                                    breaker_failure_rate=0.5,
                                    breaker_cooldown_s=0.15)
        gov = mod.OverloadGovernor(params, _Queue(), tr.MetricsRegistry())
        steps = []

        def admit(priority):
            try:
                gov.admit(priority)
                steps.append("admit")
            except mod.BreakerOpenError as e:
                assert e.retryable and e.retry_after_s > 0
                steps.append("open")

        admit(1)
        for _ in range(2):
            gov.note_worker_ok()
        for _ in range(4):
            gov.note_worker_failure()
        admit(0)
        time.sleep(0.2)                  # cooldown lapses: half-open
        admit(1)
        gov.note_worker_ok()             # the probe closes it
        steps.append(gov.breaker_open() is None)
        for _ in range(3):
            gov.note_worker_failure()
        admit(1)                         # 3 < min_samples: still closed
        trail[name] = steps
    assert trail["port"] == trail["jax"] == [
        "admit", "open", "admit", True, "admit"]
