"""The fleet tier's replica half: the port's ``serve/fleet.py`` (the
consistent-hash ring, the seeded peer-fault plan, the peer content-cache
client) against the JAX package's on the same inputs, the peer-cache hit
between two port replicas over HTTP, and session adoption from the shared
handoff stream through both packages' services, on tests/test_fleet.py's
rig (``PROJ`` 64×32, camera 24×40, the soak smoke's small-rig session
params, previews off: they are not compared, and their first programs are
most of the JAX session's cost on the CPU), on the CPU.

What is compared: ring preference lists and their remap on add / remove
(equal); the fault sequence of a seed (equal); the peer client's answers,
requests and counters for the same scripted peers (equal); the adoption's
flight events, stream owners, journal states and stop counts (equal). The
port's adopted session finalizes bit for bit as its uninterrupted session
(the JAX package's own tests/test_fleet.py holds its side), and against
the JAX package's adopted session within tests/test_torch_serve.py's
tolerances: PLY points rtol 1e-5, atol 1e-3 mm, point count and colours
exact (593 points, 0.0013 mm apart at most, here). Every wait has its own
bound.
"""

import dataclasses
import io
import json
import os
import random
import threading
import time
import urllib.error

import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu import serve as jserve
from structured_light_for_3d_model_replication_tpu.config import (
    ProjectorConfig as JProjectorConfig,
)
from structured_light_for_3d_model_replication_tpu.io import ply as jply
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
    events as jevents,
)
from structured_light_for_3d_model_replication_tpu.utils import (
    trace as jtrace,
)
from structured_light_for_3d_model_replication_tpu_torch import serve
from structured_light_for_3d_model_replication_tpu_torch.config import (
    ProjectorConfig,
)
from structured_light_for_3d_model_replication_tpu_torch.io import ply
from structured_light_for_3d_model_replication_tpu_torch.models import merge
from structured_light_for_3d_model_replication_tpu_torch.ops.triangulate import (
    calibration_from_numpy,
)
from structured_light_for_3d_model_replication_tpu_torch.stream import (
    StreamParams,
)
from structured_light_for_3d_model_replication_tpu_torch.utils import (
    events,
    trace,
)

PROJ = ProjectorConfig(width=64, height=32)
JPROJ = JProjectorConfig(width=64, height=32)
H, W = 24, 40
WAIT_S = 120.0
#: scripts/soak_smoke.py's small-rig session params, previews off.
STREAM = dict(method="posegraph", view_cap=1024, preview_points=1024,
              preview_depth=4, final_depth=5, model_cap=8192, window=3,
              representation="poisson", preview_every=0)
MERGE = dict(voxel_size=4.0, ransac_iterations=512, icp_iterations=8,
             fpfh_max_nn=24, normals_k=8, max_points=1024,
             posegraph_iterations=10, step_deg=12.0)
PACKAGES = {"port": (serve, trace), "jax": (jserve, jtrace)}


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


def _carried(h, w, _memo={}):
    """The JAX service's synthetic calibration, carried into the port."""
    if (h, w) not in _memo:
        jcal = jsynthetic_calib_provider(JPROJ)(h, w)
        _memo[(h, w)] = calibration_from_numpy(
            {k: np.asarray(v) for k, v in jcal._asdict().items()},
            device="cpu")
    return _memo[(h, w)]


def _service(pkg, store_dir=None, **kw):
    """A one-worker service of ``pkg`` ("port" or "jax") on the rig."""
    if pkg == "port":
        stream = dataclasses.replace(StreamParams(),
                                     merge=merge.MergeParams(**MERGE),
                                     **STREAM)
        cfg = serve.ServeConfig(
            device="cpu", proj=PROJ, buckets=((H, W),), batch_sizes=(1, 2),
            linger_ms=5.0, queue_depth=16, workers=1, store_dir=store_dir,
            stream=stream, warmup=False, warmup_sessions=False, **kw)
        return serve.ReconstructionService(cfg, calib_provider=_carried)
    stream = dataclasses.replace(JStreamParams(),
                                 merge=jmerge.MergeParams(**MERGE), **STREAM)
    cfg = jserve.ServeConfig(
        proj=JPROJ, buckets=((H, W),), batch_sizes=(1, 2), linger_ms=5.0,
        queue_depth=16, workers=1, store_dir=store_dir, stream=stream,
        warmup=False, warmup_sessions=False, **kw)
    return jserve.ReconstructionService(cfg)


# ---------------------------------------------------------------------------
# The ring and the fault plan (no HTTP)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vnodes", [8, 64])
def test_hash_ring_matches_jax(vnodes):
    """Same nodes and keys → the same preference lists as the JAX ring,
    before and after a node leaves and another joins; a removal remaps
    only the departed node's keys, an addition only to the new node."""
    nodes = ["http://127.0.0.1:8001", "http://127.0.0.1:8002",
             "http://127.0.0.1:8003"]
    keys = [f"key-{i}" for i in range(300)]
    rings = {n: mod.HashRing(nodes, vnodes=vnodes)
             for n, (mod, _) in PACKAGES.items()}

    def prefs(ring, avoid=()):
        return [ring.preference(k, avoid=avoid) for k in keys]

    assert prefs(rings["port"]) == prefs(rings["jax"])
    assert prefs(rings["port"], avoid={nodes[0]}) == \
        prefs(rings["jax"], avoid={nodes[0]})
    owners = {k: rings["port"].node_for(k) for k in keys}
    for ring in rings.values():
        ring.remove(nodes[1])
    assert prefs(rings["port"]) == prefs(rings["jax"])
    for k in keys:
        new = rings["port"].node_for(k)
        assert new == owners[k] if owners[k] != nodes[1] else new != nodes[1]
    for ring in rings.values():
        ring.add("http://127.0.0.1:8004")
    assert prefs(rings["port"]) == prefs(rings["jax"])
    assert rings["port"].nodes == rings["jax"].nodes
    moved = [k for k in keys
             if rings["port"].node_for(k) != owners[k]
             and owners[k] != nodes[1]]
    assert moved and all(rings["port"].node_for(k)
                         == "http://127.0.0.1:8004" for k in moved)


class _Inner:
    def request(self, method, url, body=None, headers=None, timeout_s=5.0):
        return 200, {}, b"ok"


def _fault_trail(mod, plan, n=96):
    slept = []
    t = mod.FaultyPeerTransport(plan, inner=_Inner(), sleep=slept.append)
    trail = []
    for _ in range(n):
        try:
            t.get("http://x/cache/k", timeout_s=1.0)
            trail.append("ok")
        except OSError:
            trail.append("drop")
    return trail, slept, (t.drops, t.delays)


def test_peer_fault_plan_env_and_sequence_match_jax(monkeypatch):
    """``SL_PEER_FAULTS`` parses to the same plan in both packages
    (unknown keys ignored, malformed JSON refused), and a seed gives the
    JAX package's drop / delay sequence."""
    spec = {"seed": 7, "drop_rate": 0.5, "latency_s": 0.2,
            "latency_rate": 0.5}
    monkeypatch.setenv("SL_PEER_FAULTS", json.dumps(dict(spec, bogus=1)))
    plan = serve.PeerFaultPlan.from_env()
    jplan = jserve.PeerFaultPlan.from_env()
    assert dataclasses.asdict(plan) == dataclasses.asdict(jplan) == spec
    port, jax_ = _fault_trail(serve, plan), _fault_trail(jserve, jplan)
    assert port == jax_
    assert port[2][0] > 10 and port[2][1] > 5
    assert port[1] and all(s == 0.2 for s in port[1])
    from structured_light_for_3d_model_replication_tpu_torch.serve import (
        fleet,
    )

    assert isinstance(fleet.transport_from_env(), serve.FaultyPeerTransport)
    monkeypatch.setenv("SL_PEER_FAULTS", "not json")
    assert serve.PeerFaultPlan.from_env() is None
    assert type(fleet.transport_from_env()) is serve.PeerTransport
    monkeypatch.delenv("SL_PEER_FAULTS")
    assert type(fleet.transport_from_env()) is serve.PeerTransport


# ---------------------------------------------------------------------------
# The peer content-cache client against scripted peers
# ---------------------------------------------------------------------------


class _FakeTransport:
    """Scriptable peer endpoint: {url_prefix: {key: (payload, meta,
    fmt)}}; unknown keys 404. Records every request."""

    def __init__(self, peers: dict, delay_s: float = 0.0,
                 fail: set | None = None):
        self.peers = peers
        self.delay_s = delay_s
        self.fail = fail or set()
        self.calls: list[str] = []
        self.lock = threading.Lock()

    def get(self, url, timeout_s=5.0):
        with self.lock:
            self.calls.append(url)
        base, _, key = url.rpartition("/cache/")
        if base in self.fail:
            raise urllib.error.URLError(ConnectionRefusedError("down"))
        if self.delay_s:
            time.sleep(self.delay_s)
        entry = self.peers.get(base, {}).get(key)
        if entry is None:
            return 404, {}, b"{}"
        payload, meta, fmt = entry
        return 200, {"X-Content-Meta": json.dumps(meta),
                     "X-Content-Format": fmt}, payload


def _client(pkg, peers, transport, **kw):
    mod, tr = PACKAGES[pkg]
    return mod.PeerCacheClient(peers, transport=transport,
                               registry=tr.MetricsRegistry(),
                               rng=random.Random(0), **kw)


def test_peer_cache_hit_miss_and_negative_ttl_match_jax():
    """A hit, a fleet-wide miss, the negative TTL serving the repeat
    without a request, and the re-probe after it lapses: the same answers,
    the same requests in the same order and the same counters."""
    out = {}
    for pkg in PACKAGES:
        t = _FakeTransport({"http://a": {"k1": (b"mesh", {"points": 3},
                                                "ply")}})
        pc = _client(pkg, ["http://a", "http://b"], t, negative_ttl_s=0.5)
        got = [pc.lookup("k1"), pc.lookup("k2")]
        n = len(t.calls)
        got.append(pc.lookup("k2"))
        assert len(t.calls) == n            # served from the negative TTL
        time.sleep(0.6)
        got.append(pc.lookup("k2"))         # lapsed: re-probed
        assert len(t.calls) > n
        st = pc.stats()
        out[pkg] = (got, list(t.calls), {k: st[k] for k in (
            "hits", "misses", "fetch_failures", "skips", "breaker_trips",
            "negative_entries", "inflight")})
    assert out["port"] == out["jax"]
    assert out["port"][0][0] == (b"mesh", {"points": 3}, "ply")
    assert out["port"][2]["hits"] == 1 and out["port"][2]["misses"] == 2


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_peer_cache_single_flight(pkg):
    """Six concurrent lookups of one key share ONE peer fetch."""
    t = _FakeTransport({"http://a": {"k": (b"x", {}, "ply")}}, delay_s=0.15)
    pc = _client(pkg, ["http://a"], t, budget_s=2.0)
    results = []
    threads = [threading.Thread(target=lambda: results.append(
        pc.lookup("k"))) for _ in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(10.0)
    assert len(results) == 6
    assert all(r is not None and r[0] == b"x" for r in results)
    assert len(t.calls) == 1


def test_peer_breaker_and_backoff_match_jax():
    """A dead peer trips its breaker after the minimum samples and is
    skipped from then on; backoff alone suppresses re-probes: the same
    requests and counters as the JAX client."""
    out = {}
    for pkg in PACKAGES:
        t = _FakeTransport({"http://b": {}}, fail={"http://a"})
        pc = _client(pkg, ["http://a", "http://b"], t, negative_ttl_s=0.0,
                     breaker_min_samples=2, breaker_failure_rate=0.5,
                     breaker_cooldown_s=30.0, backoff_base_s=0.0)
        answers = [pc.lookup(f"k{i}") for i in range(6)]
        st = pc.stats()
        t2 = _FakeTransport({}, fail={"http://a"})
        pc2 = _client(pkg, ["http://a"], t2, negative_ttl_s=0.0,
                      breaker_min_samples=99, backoff_base_s=60.0)
        answers += [pc2.lookup(f"k{i}") for i in range(4)]
        out[pkg] = (answers, list(t.calls), list(t2.calls),
                    {k: st[k] for k in ("skips", "breaker_trips",
                                        "fetch_failures", "misses")},
                    [p["consecutive_failures"] for p in st["peers"]])
    assert out["port"] == out["jax"]
    answers, calls, calls2, st, _ = out["port"]
    assert answers == [None] * 10
    assert sum(u.startswith("http://a/") for u in calls) == 2
    assert st["skips"] == 4 and st["breaker_trips"] == 1
    assert len(calls2) == 1


def test_peer_lookup_budget_never_stalls():
    """Three slow peers against a 0.3 s budget: the lookup misses within
    the budget and one request's tail, not three requests' sum."""
    t = _FakeTransport({"http://a": {}, "http://b": {}, "http://c": {}},
                       delay_s=0.2)
    pc = _client("port", ["http://a", "http://b", "http://c"], t,
                 timeout_s=1.0, budget_s=0.3)
    t0 = time.monotonic()
    assert pc.lookup("k") is None
    assert time.monotonic() - t0 < 0.75
    assert len(t.calls) < 3


# ---------------------------------------------------------------------------
# Two port replicas over HTTP
# ---------------------------------------------------------------------------


def test_service_builds_its_peer_cache_from_config():
    """``peers`` builds the peer client (with the content cache on) as the
    JAX service does; without peers, or without a content cache, none."""
    for pkg in PACKAGES:
        with_peers = _service(pkg, peers=("http://127.0.0.1:1/",),
                              peer_timeout_s=0.5, peer_budget_s=0.7)
        assert with_peers.peer_cache.peer_urls == ["http://127.0.0.1:1"]
        assert with_peers.peer_cache.timeout_s == 0.5
        assert with_peers.peer_cache.budget_s == 0.7
        assert _service(pkg).peer_cache is None
        assert _service(pkg, peers=("http://127.0.0.1:1",),
                        content_cache=False).peer_cache is None


def test_cross_replica_peer_cache_hit_http(serve_stack):
    """A duplicate submitted to replica B is answered at admission from
    replica A's content cache over ``GET /cache/<key>``: the bytes A
    computed, then a local hit; A's own admission counters untouched; a
    novel stack misses fleet-wide and computes on B."""
    a = _service("port").start()
    ha = serve.ServeHTTPServer(a, port=0).start()
    b = None
    try:
        done = a.submit_array(serve_stack)
        assert done.wait(WAIT_S) and done.status == "done"
        b = _service("port", peers=(f"http://127.0.0.1:{ha.port}",)).start()
        dup = b.submit_array(serve_stack)
        assert dup.status == "done"
        assert dup.result_meta["content_cache_hit"] is True
        assert dup.result_meta["cache_source"] == "peer"
        assert dup.result_bytes == done.result_bytes
        assert b.peer_cache.stats()["hits"] == 1
        dup2 = b.submit_array(serve_stack)
        assert dup2.result_meta["cache_source"] == "local"
        assert dup2.result_bytes == done.result_bytes
        assert a.content_cache.stats()["hits"] == 0
        novel = b.submit_array(serve_stack + np.uint8(3))
        assert novel.wait(WAIT_S) and novel.status == "done"
        assert not novel.result_meta.get("content_cache_hit")
        assert 'serve_peer_cache_hits_total 1' in b.metrics_text()
    finally:
        ha.stop()
        assert a.drain(timeout=WAIT_S)
        if b is not None:
            assert b.drain(timeout=WAIT_S)


# ---------------------------------------------------------------------------
# Session adoption from the handoff stream, both packages
# ---------------------------------------------------------------------------


def _kinds(ev) -> list[str]:
    """The flight events recorded since the recorder was last cleared."""
    return [e.kind for e in ev.RECORDER.tail()]


def _adopt(pkg, root, serve_ring) -> dict:
    """tests/test_fleet.py's adoption sequence on ``pkg``: replica A takes
    2 stops and dies without a drain; B adopts (then again: a no-op),
    takes stops 3 and 4 and finalizes; A restarts with recovery and skips
    the handed-off session. Returns what the packages are compared on and
    the finalized PLY."""
    mod = PACKAGES[pkg][0]
    ev = events if pkg == "port" else jevents
    shared = str(root / "handoff")
    ev.RECORDER.clear()
    a = _service(pkg, str(root / "va"), handoff_dir=shared,
                 replica_id="rA").start()
    sid = a.create_session({})["session_id"]
    for s in serve_ring[:2]:
        assert a.submit_session_stop(sid, s).wait(WAIT_S)
    a.abort()
    owner_before = mod.SessionStreamStore(shared).owner(sid)
    b = _service(pkg, str(root / "vb"), handoff_dir=shared,
                 replica_id="rB").start()
    try:
        first = b.adopt_session(sid)
        again = b.adopt_session(sid)
        owner_after = mod.SessionStreamStore(shared).owner(sid)
        for s in serve_ring[2:]:
            assert b.submit_session_stop(sid, s).wait(WAIT_S)
        fused = b.sessions.get(sid).session.stops_fused
        fin = b.finalize_session(sid, "ply")
    finally:
        assert b.drain(timeout=WAIT_S)
    after_b = (mod.read_live_state(str(root / "vb")).empty,
               mod.SessionStreamStore(shared).list_sessions())
    a2 = _service(pkg, str(root / "va"), handoff_dir=shared,
                  replica_id="rA").start(recover_from=True)
    with pytest.raises(Exception):
        a2.sessions.get(sid)
    assert a2.drain(timeout=WAIT_S)
    kinds = _kinds(ev)
    return {"outcome": {
        "first": {k: first[k] for k in ("adopted", "stops_fused")},
        "again": {k: again[k] for k in ("adopted", "stops_fused")},
        "owners": (owner_before, owner_after),
        "fused": fused, "finalize": fin.status,
        "after_b": after_b,
        "a_recovered_clean": mod.read_live_state(str(root / "va")).empty,
        "events": [k for k in ("session_adopted",
                               "session_skipped_handed_off")
                   if k in kinds]},
        "ply": fin.result_bytes}


def _uninterrupted(serve_ring) -> bytes:
    """The port's session over the whole ring, never killed."""
    ref = _service("port").start()
    try:
        sid = ref.create_session({})["session_id"]
        for s in serve_ring:
            assert ref.submit_session_stop(sid, s).wait(WAIT_S)
        return ref.finalize_session(sid, "ply").result_bytes
    finally:
        assert ref.drain(timeout=WAIT_S)


def test_adopt_session_from_handoff_stream_matches_jax(tmp_path,
                                                       serve_ring):
    port = _adopt("port", tmp_path / "port", serve_ring)
    jax_ = _adopt("jax", tmp_path / "jax", serve_ring)
    assert port["outcome"] == jax_["outcome"]
    assert port["outcome"] == {
        "first": {"adopted": True, "stops_fused": 2},
        "again": {"adopted": False, "stops_fused": 2},
        "owners": ("rA", "rB"), "fused": 4, "finalize": "done",
        "after_b": (True, []), "a_recovered_clean": True,
        "events": ["session_adopted", "session_skipped_handed_off"]}
    # The adopted session finalizes bit for bit as an uninterrupted one.
    assert port["ply"] == _uninterrupted(serve_ring)
    got = ply.read_ply(io.BytesIO(port["ply"]))
    ref = jply.read_ply(io.BytesIO(jax_["ply"]))
    assert len(got) == len(ref) > 100
    np.testing.assert_allclose(got.points, ref.points, rtol=1e-5, atol=1e-3)
    assert np.array_equal(got.colors, ref.colors)


class _OnCard(torch.Tensor):
    """A CPU tensor that, like a card's, reaches numpy only through
    ``.cpu()``."""

    def __array__(self, dtype=None, copy=None):
        raise TypeError("can't convert cuda:0 device type tensor to numpy")

    def cpu(self, *args, **kwargs):
        return self.as_subclass(torch.Tensor)


def test_replay_reads_the_batch_result_through_the_host(tmp_path,
                                                         serve_ring):
    """Adoption and crash recovery replay journaled stops through the
    bucket's program; its result is read back as the worker reads it
    (``.cpu()``), which a card's tensors need: with the program's
    outputs refusing ``np.asarray``, both replays still fuse every
    stop."""
    shared = str(tmp_path / "handoff")
    a = _service("port", str(tmp_path / "va"), handoff_dir=shared,
                 replica_id="rA").start()
    sid = a.create_session({})["session_id"]
    for s in serve_ring[:2]:
        assert a.submit_session_stop(sid, s).wait(WAIT_S)
    a.abort()

    def on_card(svc):
        get = svc.cache.get

        def wrapped(key):
            program = get(key)

            def run(*args):
                out = program(*args)
                return out._replace(**{k: getattr(out, k).as_subclass(
                    _OnCard) for k in ("points", "colors", "valid")})
            return run
        svc.cache.get = wrapped
        return svc

    b = on_card(_service("port", str(tmp_path / "vb"), handoff_dir=shared,
                         replica_id="rB"))
    b.start()
    try:
        out = b.adopt_session(sid)
        assert out["adopted"] and out["stops_fused"] == 2
        assert out["stops_degraded"] == 0
    finally:
        b.abort()
    b2 = on_card(_service("port", str(tmp_path / "vb"), handoff_dir=shared,
                          replica_id="rB"))
    b2.start(recover_from=True)
    try:
        assert b2.sessions.get(sid).session.stops_fused == 2
        b2.sessions.delete(sid)
    finally:
        assert b2.drain(timeout=WAIT_S)


def _recover_without_stream(pkg, root, serve_ring) -> dict:
    """tests/test_fleet.py's missing-stream recovery on ``pkg``."""
    mod = PACKAGES[pkg][0]
    ev = events if pkg == "port" else jevents
    shared, va = str(root / "handoff"), str(root / "va")
    ev.RECORDER.clear()
    a = _service(pkg, va, handoff_dir=shared, replica_id="rA").start()
    sid = a.create_session({})["session_id"]
    assert a.submit_session_stop(sid, serve_ring[0]).wait(WAIT_S)
    a.abort()
    mod.SessionStreamStore(shared).drop_session(sid)
    a2 = _service(pkg, va, handoff_dir=shared,
                  replica_id="rA").start(recover_from=True)
    try:
        fused = a2.sessions.get(sid).session.stops_fused
        sink = mod.SessionStreamStore(shared)
        info = sink.read_session(sid)
        healed = (sink.has_session(sid), info.replica, len(info.stops))
        a2.sessions.delete(sid)
        assert a2.drain(timeout=WAIT_S)
    finally:
        if any(w.alive for w in a2.workers):
            a2.abort()
    return {"fused": fused, "healed": healed,
            "event": "session_recovered_without_stream" in _kinds(ev),
            "clean": (mod.read_live_state(va).empty,
                      mod.SessionStreamStore(shared).list_sessions())}


def test_recover_session_when_handoff_stream_missing_matches_jax(
        tmp_path, serve_ring):
    port = _recover_without_stream("port", tmp_path / "port", serve_ring)
    jax_ = _recover_without_stream("jax", tmp_path / "jax", serve_ring)
    assert port == jax_ == {"fused": 1, "healed": (True, "rA", 1),
                            "event": True, "clean": (True, [])}
