"""The fleet's front router: the port's ``serve/router.py`` against the JAX
package's on the same inputs, port replicas behind it over real HTTP, and
one fleet chaos run of subprocess replicas, on tests/test_fleet.py's rig
(``PROJ`` 64×32, camera 24×40, the soak smoke's small-rig session params),
on the CPU.

What is compared with the JAX router (the routing brain is host code, so
the same inputs must give the same decisions): consistent-hash placement
and its load-weighted demotion, the weighted round-robin of session
creation, the failure detector's hysteresis, ``signals()`` and the
corrupt-blob summary from the same replica snapshots (dead devices
included), the pin board's records (each package reads the other's), and
over HTTP the replica each package's router places a submit on and
routes a session to. The port's router listens with the replica's
128-deep accept backlog, where the JAX router keeps the stdlib's 5 (an
allowed difference: ROADMAP Queue 3). The chaos run is bench config 10
(``chip_smoke.fleet_chaos``, the script's own phase 8e) with three
``cli serve --device cpu`` replicas and 10 s of load. Every wait has its
own bound.
"""

import dataclasses
import hashlib
import importlib.util
import json
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu import serve as jserve
from structured_light_for_3d_model_replication_tpu.config import (
    ProjectorConfig as JProjectorConfig,
)
from structured_light_for_3d_model_replication_tpu.models import (
    synthetic as jsynthetic,
)
from structured_light_for_3d_model_replication_tpu.serve.router import (
    PinBoard as JPinBoard,
)
from structured_light_for_3d_model_replication_tpu_torch import serve
from structured_light_for_3d_model_replication_tpu_torch.config import (
    ProjectorConfig,
)
from structured_light_for_3d_model_replication_tpu_torch.models import merge
from structured_light_for_3d_model_replication_tpu_torch.serve.router import (
    PinBoard,
)
from structured_light_for_3d_model_replication_tpu_torch.stream import (
    StreamParams,
)
from structured_light_for_3d_model_replication_tpu_torch.utils import events

REPO = pathlib.Path(__file__).resolve().parents[1]
PROJ = ProjectorConfig(width=64, height=32)
JPROJ = JProjectorConfig(width=64, height=32)
H, W = 24, 40
WAIT_S = 120.0
STREAM = dict(method="posegraph", view_cap=1024, preview_points=1024,
              preview_depth=4, final_depth=5, model_cap=8192, window=3,
              representation="poisson", preview_every=0)
MERGE = dict(voxel_size=4.0, ransac_iterations=512, icp_iterations=8,
             fpfh_max_nn=24, normals_k=8, max_points=1024,
             posegraph_iterations=10, step_deg=12.0)
URLS = [f"http://127.0.0.1:{p}" for p in (1, 2, 3)]


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
    """tests/test_fleet.py's four turntable views."""
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


def _routers(**kw):
    """(port, JAX) routers over the same replica URLs, every replica ready,
    no thread started."""
    out = []
    for mod in (serve, jserve):
        r = mod.FleetRouter(URLS, check_interval_s=999.0,
                            router_id="router-w", **kw)
        with r._lock:
            for u in URLS:
                r._ready[u] = True
        out.append(r)
    return out


def _set_stats(routers, url, snap):
    for r in routers:
        with r._lock:
            r._replica_stats[url] = json.loads(json.dumps(snap))


# ---------------------------------------------------------------------------
# The routing brain against the JAX router (no HTTP)
# ---------------------------------------------------------------------------


def test_weighted_placement_matches_jax():
    """Equal weights: the pure ring order and an even round-robin; one
    replica degraded (1 of 2 devices dead, queue half full): the same
    weights, the same demotions per key and the same pick sequence."""
    port, jax_ = _routers()
    bodies = [f"stack-{i}".encode() for i in range(200)]
    assert port.replica_weight(URLS[0]) == jax_.replica_weight(URLS[0]) == 1.0
    assert [port.place_submit(b) for b in bodies] == \
        [jax_.place_submit(b) for b in bodies]
    assert port.place_submit(bodies[0]) == port.ring.preference(
        hashlib.sha256(bodies[0]).hexdigest(), avoid=set())
    picks = [port.next_replica() for _ in range(6)]
    assert picks == [jax_.next_replica() for _ in range(6)]
    assert all(picks.count(u) == 2 for u in URLS)
    _set_stats((port, jax_), URLS[0], {
        "queue_depth": 4, "queue_capacity": 8,
        "lanes": {"devices": ["cpu:0", "cpu:1"], "devices_dead": ["cpu:1"],
                  "devices_live": 1}})
    assert port.replica_weight(URLS[0]) == jax_.replica_weight(URLS[0]) \
        == pytest.approx(0.25)
    placed = [port.place_submit(b) for b in bodies]
    assert placed == [jax_.place_submit(b) for b in bodies]
    assert all(sorted(p) == sorted(URLS) for p in placed)
    picks = [port.next_replica() for _ in range(90)]
    assert picks == [jax_.next_replica() for _ in range(90)]
    assert 1 <= picks.count(URLS[0]) < picks.count(URLS[1])
    # A replica down drops out of placement in both.
    for r in (port, jax_):
        r._set_ready(URLS[1], False, "readyz 503")
    assert [port.place_submit(b) for b in bodies] == \
        [jax_.place_submit(b) for b in bodies]
    assert all(URLS[1] not in port.place_submit(b) for b in bodies)


def test_detector_hysteresis_matches_jax():
    """The same readiness sequence gives the same alive → suspect → dead
    → alive trail (2 misses suspect, 3 dead, 2 hits back)."""
    port, jax_ = _routers(proactive_repin=False, suspect_misses=2,
                          dead_misses=3, recover_hits=2)
    seq = [False, True, True, False, False, False, False, True, False,
           True, True, False]
    trails = []
    for r in (port, jax_):
        trail = []
        for ready in seq:
            r._detect(URLS[0], ready)
            trail.append(r.detector_state(URLS[0]))
        trails.append(trail)
    assert trails[0] == trails[1]
    assert trails[0][:7] == ["alive", "alive", "alive", "alive", "suspect",
                             "dead", "dead"]
    assert trails[0][10] == "alive"


def test_signals_dead_devices_and_corrupt_blobs_match_jax():
    """``signals()`` and the corrupt-blob summary from the same replica
    snapshots: a replica with a dead device, one with a deep queue and
    quarantined blobs, and one not ready (its snapshot ignored)."""
    port, jax_ = _routers()
    _set_stats((port, jax_), URLS[0], {
        "queue_depth": 0, "queue_capacity": 8, "workers_alive": 2,
        "sessions": {"live": 1},
        "lanes": {"lanes": [{"index": 0, "device": "cpu:0"},
                            {"index": 1, "device": "cpu:1"}],
                  "devices_dead": ["cpu:1"], "devices_live": 1,
                  "revives_total": 2},
        "governor": {"level": 0, "memory_pressure": 0.25,
                     "shed_total": {"preview": 3}},
        "content_cache": {"corrupt_quarantined": 1,
                          "quarantined_objects": 2}})
    _set_stats((port, jax_), URLS[1], {
        "queue_depth": 6, "queue_capacity": 8, "workers_alive": 1,
        "sessions": {"live": 2},
        "lanes": {"lanes": [{"index": 0, "device": "cpu:0"}]},
        "governor": {"level": 2, "memory_pressure": 0.5,
                     "shed_total": {"low": 4}},
        "content_cache": {"corrupt_quarantined": 3,
                          "quarantined_objects": 3}})
    _set_stats((port, jax_), URLS[2], {"queue_depth": 99,
                                       "queue_capacity": 99})
    for r in (port, jax_):
        r._set_ready(URLS[2], False, "unreachable")
    sig = port.signals()
    assert sig == jax_.signals()
    assert sig["device_lanes_total"] == 2 and sig["devices_dead_total"] == 1
    assert sig["queue_frac"] == pytest.approx(6 / 16)
    assert sig["overload_level_max"] == 2 and sig["shed_total"] == 7
    assert port.corrupt_blob_summary() == jax_.corrupt_blob_summary()
    assert port.corrupt_blob_summary()["corrupt_quarantined_total"] == 4


def test_pin_board_records_read_across_packages(tmp_path):
    """Session and job pins a port router writes, a JAX router reads, and
    the reverse; the (gen, router) order and TTL pruning agree."""
    store = serve.open_blob_store(str(tmp_path / "board"))
    jstore = jserve.open_blob_store(str(tmp_path / "board"))
    rA = serve.FleetRouter(URLS[:1], check_interval_s=999.0,
                           router_id="router-a", pin_store=store)
    rA.pin_job("job-1", "http://replica-x:1")
    assert rA._flush_job_pins() == 1
    rA.pin_session("s1", "http://replica-x:1")
    rJ = jserve.FleetRouter(URLS[:1], check_interval_s=999.0,
                            router_id="router-b", pin_store=jstore)
    assert rJ.job_url("job-1") == "http://replica-x:1"
    assert rJ.session_url("s1") == "http://replica-x:1"
    rJ.pin_session("s1", "http://replica-y:1")      # gen 2 by router-b
    assert PinBoard(store, "router-c").read("s1") == \
        ("http://replica-y:1", 2, "router-b")
    # A lower-ranked write does not clobber the higher record.
    PinBoard(store, "router-a").write("s1", "http://replica-z:1", 1)
    assert JPinBoard(jstore, "router-c").read("s1")[0] == \
        "http://replica-y:1"
    assert rA.session_url("s1") == "http://replica-x:1"   # local memory
    rA._sync_board()
    assert rA.session_url("s1") == "http://replica-y:1"
    board, jboard = PinBoard(store, "router-c"), JPinBoard(jstore, "r")
    store.put(board._job_key("torn"), b"{not json")
    assert board.read_job("torn") is None is jboard.read_job("torn")
    rec = json.loads(store.get(board._job_key("job-1")).decode())
    rec["t_wall"] = time.time() - 7200.0
    store.replace(board._job_key("job-1"), json.dumps(rec).encode())
    jboard.write_job("job-2", "http://replica-y:1")
    assert board.prune_jobs(ttl_s=3600.0) == 1
    assert jboard.read_job("job-1") is None
    assert board.read_job("job-2") == "http://replica-y:1"


def test_router_listener_backlog_is_the_replicas():
    """The port's router listens with the replica's 128-deep accept
    backlog (ROADMAP Queue 3: the JAX router keeps the stdlib's 5)."""
    router = serve.FleetRouter(URLS[:1], check_interval_s=999.0)
    rh = serve.RouterHTTPServer(router, port=0)
    try:
        assert rh._httpd.request_queue_size == 128
        assert jserve.RouterHTTPServer(
            jserve.FleetRouter(URLS[:1]), port=0)._httpd.request_queue_size \
            == 5
    finally:
        rh.stop()


# ---------------------------------------------------------------------------
# Port replicas behind the router over HTTP
# ---------------------------------------------------------------------------


def _config(store_dir=None, **kw):
    stream = dataclasses.replace(StreamParams(),
                                 merge=merge.MergeParams(**MERGE), **STREAM)
    return serve.ServeConfig(
        device="cpu", proj=PROJ, buckets=((H, W),), batch_sizes=(1, 2),
        linger_ms=5.0, queue_depth=16, workers=1, store_dir=store_dir,
        stream=stream, warmup=False, warmup_sessions=False, **kw)


def _replicas(tmp_path, n=2):
    members = []
    for i in range(n):
        svc = serve.ReconstructionService(_config(
            str(tmp_path / f"v{i}"), handoff_dir=str(tmp_path / "handoff"),
            replica_id=f"r{i}")).start()
        members.append((svc, serve.ServeHTTPServer(svc, port=0).start()))
    return members, [f"http://127.0.0.1:{h.port}" for _, h in members]


def _teardown(members, *routers):
    for r in routers:
        r.stop()
    for svc, http in members:
        if any(w.alive for w in svc.workers):
            assert svc.drain(timeout=WAIT_S)
        http.stop()


def _status(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=30.0) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


def test_router_hash_admission_sticky_sessions_and_handoff(
        tmp_path, serve_stack, serve_ring):
    """tests/test_fleet.py's router walk on port replicas: a duplicate
    lands on the replica the JAX router also places it on and hits its
    cache; a session sticks to its pin, which a fresh router (port or
    JAX) re-learns by probing; after the pinned replica dies the next
    stop re-pins it on the survivor; definitive unknowns answer 404."""
    members, urls = _replicas(tmp_path)
    router = serve.FleetRouter(urls, check_interval_s=0.2)
    rh = serve.RouterHTTPServer(router, port=0).start()
    base = f"http://127.0.0.1:{rh.port}"
    client = serve.ServeClient(base, timeout_s=WAIT_S)
    jrouter = jserve.FleetRouter(urls, check_interval_s=0.2)
    try:
        jrouter._sweep()
        body = serve_stack.tobytes()
        assert router.place_submit(body) == jrouter.place_submit(body)
        st1 = client.wait(client.submit(serve_stack), timeout_s=WAIT_S)
        assert st1["status"] == "done"
        st2 = client.wait(client.submit(serve_stack), timeout_s=WAIT_S)
        assert st2["result"]["content_cache_hit"] is True
        assert st2["result"]["cache_source"] == "local"
        assert client.result(st2["job_id"]).startswith(b"ply")
        sid = client.create_session()
        stj = client.wait(client.submit_stop(sid, serve_ring[0]),
                          timeout_s=WAIT_S)
        assert stj["status"] == "done"
        pin = router.session_url(sid)
        assert pin in urls
        router2 = serve.FleetRouter(urls, check_interval_s=0.2).start()
        try:
            assert router2.route_session(sid) == pin \
                == jrouter.route_session(sid)
            assert router2.stats()["session_repins"] == 0
            assert jrouter.stats()["session_repins"] == 0
        finally:
            router2.stop()
        victim = members[urls.index(pin)]
        victim[0].abort()
        victim[1].stop()
        stj2 = client.wait(client.submit_stop(sid, serve_ring[1]),
                           timeout_s=WAIT_S)
        assert stj2["status"] == "done"
        assert router.session_url(sid) != pin
        assert router.stats()["session_repins"] == 1
        assert client.session_status(sid)["stops_fused"] == 2
        assert client.readyz()["ready"] is True
        assert len(router.ready_replicas()) == 1
        assert _status(base, "/session/deadbeef0000") == 404
        assert _status(base, "/session/") == 404
        client.delete_session(sid)
        assert _status(base, f"/session/{sid}") == 404
        with urllib.request.urlopen(base + "/fleet/signals",
                                    timeout=30.0) as r:
            assert json.loads(r.read())["ready_replicas"] == 1
    finally:
        rh.stop()
        _teardown(members)


def test_router_restart_relearn_races_survivor_adoption(tmp_path,
                                                        serve_ring):
    """A restarted router believes the shared board and steals nothing
    from a live replica; after the replica dies two routers racing the
    re-route converge on the one survivor, and the session is live there
    exactly once."""
    members, urls = _replicas(tmp_path)
    board = serve.InMemoryObjectClient()
    rA = serve.FleetRouter(urls, check_interval_s=0.1, router_id="router-a",
                           pin_store=serve.ObjectStore(board),
                           proactive_repin=False).start()
    rB = None
    try:
        (svc0, http0), (svc1, _) = members
        sid = svc0.create_session({})["session_id"]
        assert svc0.submit_session_stop(sid, serve_ring[0]).wait(WAIT_S)
        rA.pin_session(sid, urls[0])
        rB = serve.FleetRouter(urls, check_interval_s=0.1,
                               router_id="router-b",
                               pin_store=serve.ObjectStore(board),
                               proactive_repin=False).start()
        assert rB.session_url(sid) == rB.route_session(sid) == urls[0]
        assert rB.stats()["session_repins"] == 0
        assert svc1.sessions.stats()["live"] == 0
        svc0.abort()
        http0.stop()
        deadline = time.monotonic() + 10.0
        while urls[0] in rA.ready_replicas() + rB.ready_replicas():
            assert time.monotonic() < deadline
            time.sleep(0.05)
        results = {}
        threads = [threading.Thread(
            target=lambda n=n, r=r: results.__setitem__(
                n, r.route_session(sid)))
            for n, r in (("a", rA), ("b", rB))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        assert results == {"a": urls[1], "b": urls[1]}
        assert svc1.sessions.stats()["live"] == 1
        assert rA.session_url(sid) == rB.session_url(sid) == urls[1]
        assert rA.pin_board.read(sid)[0] == urls[1]
        assert svc1.submit_session_stop(sid, serve_ring[1]).wait(WAIT_S)
        assert svc1.finalize_session(sid, "ply").result_bytes.startswith(
            b"ply")
    finally:
        if rB is not None:
            rB.stop()
        _teardown(members, rA)


def test_proactive_detector_repins_in_background(tmp_path, serve_ring):
    """The detector adopts a dead replica's session on the survivor with
    no client op; one flapped probe is not death."""
    members, urls = _replicas(tmp_path)
    router = serve.FleetRouter(urls, check_interval_s=0.05,
                               router_id="router-a", suspect_misses=2,
                               dead_misses=3, recover_hits=2).start()
    try:
        (svc0, http0), (svc1, _) = members
        sid = svc0.create_session({})["session_id"]
        assert svc0.submit_session_stop(sid, serve_ring[0]).wait(WAIT_S)
        router.pin_session(sid, urls[0])
        router._detect(urls[0], False)
        assert router.detector_state(urls[0]) != "dead"
        router._detect(urls[0], True)
        router._detect(urls[0], True)
        assert router.detector_state(urls[0]) == "alive"
        svc0.abort()
        http0.stop()
        deadline = time.monotonic() + 30.0
        while int(router.stats()["proactive_repins"]) < 1:
            assert time.monotonic() < deadline, router.stats()
            time.sleep(0.05)
        assert router.session_url(sid) == urls[1]
        assert svc1.sessions.stats()["live"] == 1
        assert any(e.kind == "session_proactive_repin"
                   for e in events.tail(200))
        assert svc1.submit_session_stop(sid, serve_ring[1]).wait(WAIT_S)
    finally:
        _teardown(members, router)


def _announced(proc, marker: str, timeout_s: float = 60.0) -> int:
    """The port a ``cli serve`` process prints after ``marker`` on its
    standard error, read on a thread so the wait has a bound; every line
    is kept in ``proc.lines``."""
    proc.lines = []
    got = threading.Event()
    port = []

    def pump():
        for line in proc.stderr:
            proc.lines.append(line)
            if marker in line and not port:
                port.append(int(line.rsplit(":", 1)[1]))
                got.set()
        got.set()

    threading.Thread(target=pump, daemon=True).start()
    assert got.wait(timeout_s) and port, "".join(proc.lines[-20:])
    return port[0]


def test_cli_serve_router_runs_and_prints_its_stats(tmp_path):
    """``cli serve --router`` fronts the replicas it is given, answers
    ``/readyz`` and ``/fleet``, and on SIGTERM prints ``router.stats()``
    and exits 0; without ``--replicas`` it exits 2."""
    from structured_light_for_3d_model_replication_tpu_torch.cli import (
        serve as cli_serve,
    )

    assert cli_serve.main(["--router"]) == 2
    members, urls = _replicas(tmp_path, n=1)
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "structured_light_for_3d_model_replication_tpu_torch.cli", "serve",
         "--router", "--replicas", urls[0], "--port", "0",
         "--check-interval", "0.25", "--router-id", "router-cli"],
        cwd=REPO, stderr=subprocess.PIPE, text=True)
    try:
        port = _announced(proc, "routing on :")
        base = f"http://127.0.0.1:{port}"
        assert _status(base, "/readyz") == 200
        with urllib.request.urlopen(base + "/fleet", timeout=30.0) as r:
            assert json.loads(r.read())["router_id"] == "router-cli"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60.0) == 0
        time.sleep(0.2)             # the reader drains the last lines
        stats = [json.loads(ln) for ln in proc.lines
                 if ln.startswith("{")]
        assert stats and stats[-1]["replicas"][0]["url"] == urls[0]
    finally:
        if proc.poll() is None:
            proc.kill()
        _teardown(members)


# ---------------------------------------------------------------------------
# Bench config 10 on the CPU
# ---------------------------------------------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fleet_chaos_on_cpu(monkeypatch):
    """``chip_smoke.fleet_chaos`` — three ``cli serve --device cpu``
    replica processes behind the router, 10 s of load, the SIGKILL of the
    pinned replica, the proactive re-pin, a replacement with
    ``--recover`` — holds every assertion of bench config 10 and the
    port's own (the adopted session's PLY bit-equal to an uninterrupted
    one, the diagnose bundle's members), within 120 s. The replicas run
    one thread each; an unknown job is resubmitted after 5 s. The burst
    is 16 jobs, not the bench's 4: the victim runs 2 of 4 before its kill
    on a quiet host and can run all 4 on a loaded one, and the bench's
    "≥ 1 recovered" needs one left."""
    smoke = _chip_smoke()

    def fail(msg):
        raise AssertionError(msg)

    monkeypatch.setattr(smoke, "fail", fail)
    t0 = time.monotonic()
    out = smoke.fleet_chaos(torch.device("cpu"), load_s=10.0,
                            env={"OMP_NUM_THREADS": "1"}, start_s=60.0,
                            resubmit_s=5.0, burst_jobs=16)
    assert time.monotonic() - t0 < 120.0
    assert all(out["checks"].values()), out["checks"]
    assert out["proactive_repins_before_first_op"] >= 1
    assert out["recovered_burst_jobs"] >= 1
    assert out["counters"]["done"] >= 6
    assert set(out["exit_codes"].values()) == {0}
    assert smoke.DIAGNOSE_MEMBERS <= set(out["bundle_members"])
    # On the CPU the wrappers take their plain versions: no launches.
    assert all(n == 0 for s in out["scrapes"].values()
               for n in s["launches"].values())
    assert np.isfinite(out["fleet_scans_per_s"])
