"""One serving replica: the port's ``serve/`` against the JAX package's on
tests/test_serve.py's rig (``PROJ`` 64×32, 24-frame protocol, buckets
24×40), both services with one worker on the CPU, the port's calibration
carried across from the JAX one (``calibration_from_numpy``).

Tolerances (tests/test_torch_pipeline.py's contract): PLY points rtol 1e-5,
atol 1e-3 mm; point counts (valid) and colours exact; STL results at
``mesh_depth`` 6 the same point count and face counts within 0.1% (the
tightest that holds: 70,794 against 70,802 — the Poisson solve's float32
sums run in another order, and tests/test_torch_meshing.py holds meshes to
1% for that reason). Every wait has its own bound.
"""

import io
import os
import threading

import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.config import (
    ProjectorConfig as JProjectorConfig,
)
from structured_light_for_3d_model_replication_tpu.io import ply as jply
from structured_light_for_3d_model_replication_tpu.io import stl as jstl
from structured_light_for_3d_model_replication_tpu.models import (
    synthetic as jsynthetic,
)
from structured_light_for_3d_model_replication_tpu.serve import (
    ReconstructionService as JService,
)
from structured_light_for_3d_model_replication_tpu.serve import (
    ServeConfig as JServeConfig,
)
from structured_light_for_3d_model_replication_tpu.serve.service import (
    synthetic_calib_provider as jsynthetic_calib_provider,
)
from structured_light_for_3d_model_replication_tpu_torch.config import (
    ProjectorConfig,
)
from structured_light_for_3d_model_replication_tpu_torch.io import ply, stl
from structured_light_for_3d_model_replication_tpu_torch.ops.triangulate import (
    calibration_from_numpy,
)
from structured_light_for_3d_model_replication_tpu_torch.serve import (
    ProgramCache,
    ProgramKey,
    QueueFullError,
    ReconstructionService,
    ServeClient,
    ServeConfig,
    ServeHTTPServer,
)
from structured_light_for_3d_model_replication_tpu_torch.serve.batcher import (
    BucketKey,
)
from structured_light_for_3d_model_replication_tpu_torch.serve.client import (
    BackpressureError,
)
from structured_light_for_3d_model_replication_tpu_torch.serve.service import (
    synthetic_calib_provider,
)
from structured_light_for_3d_model_replication_tpu_torch.utils import trace

PROJ = ProjectorConfig(width=64, height=32)     # 6+5 bits, 24 frames
JPROJ = JProjectorConfig(width=64, height=32)
H, W = 24, 40
BATCH_SIZES = (1, 2, 4)
WAIT_S = 60.0


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
def stacks():
    """Four variants of one rendered stop filling the bucket exactly."""
    rig = jsynthetic.default_calibration(H, W, JPROJ)
    stack, _ = jsynthetic.render_scan(jsynthetic.Scene(), *rig, H, W, JPROJ)
    return [np.ascontiguousarray(stack + np.uint8(i)) for i in range(4)]


def carried_provider():
    """The JAX service's synthetic calibration, carried into the port."""
    jprov = jsynthetic_calib_provider(JPROJ)
    memo = {}

    def provider(h, w):
        if (h, w) not in memo:
            memo[(h, w)] = calibration_from_numpy(
                {k: np.asarray(v) for k, v in jprov(h, w)._asdict().items()},
                device="cpu")
        return memo[(h, w)]

    return provider


def _config(cls, proj, **kw):
    kw = dict(dict(proj=proj, buckets=((H, W),), batch_sizes=BATCH_SIZES,
                   linger_ms=5.0, queue_depth=16, workers=1, mesh_depth=6,
                   warmup_sessions=False, content_cache=False), **kw)
    if cls is ServeConfig:
        kw["device"] = "cpu"
    return cls(**kw)


@pytest.fixture(scope="module")
def services():
    """(port, JAX) services, started, each behind its own HTTP front."""
    port = ReconstructionService(_config(ServeConfig, PROJ),
                                 calib_provider=carried_provider()).start()
    jax_svc = JService(_config(JServeConfig, JPROJ)).start()
    fronts = [ServeHTTPServer(port, port=0).start(),
              ServeHTTPServer(jax_svc, port=0).start()]
    yield port, jax_svc, [ServeClient(f"http://127.0.0.1:{f.port}",
                                      retries=0) for f in fronts]
    for f in fronts:
        f.stop()
    assert port.drain(timeout=WAIT_S) and jax_svc.drain(timeout=WAIT_S)


def _done(svc, stack, **kw):
    job = svc.submit_array(stack, **kw)
    assert job.wait(WAIT_S), "job did not reach a terminal state"
    assert job.status == "done", job.status_dict()
    return job


def _same_cloud(a: bytes, b: bytes) -> None:
    got = ply.read_ply(io.BytesIO(a))
    ref = jply.read_ply(io.BytesIO(b))
    assert len(got) == len(ref) > 0
    np.testing.assert_allclose(got.points, ref.points, rtol=1e-5, atol=1e-3)
    assert np.array_equal(got.colors, ref.colors)


def test_ply_results_match_jax_in_process_and_over_http(services, stacks):
    port, jax_svc, (client, jclient) = services
    jobs = [(port.submit_array(s), jax_svc.submit_array(s)) for s in stacks]
    for job, jjob in jobs:
        assert job.wait(WAIT_S) and jjob.wait(WAIT_S)
        assert job.status == jjob.status == "done", job.status_dict()
        assert job.result_meta == jjob.result_meta
        _same_cloud(job.result_bytes, jjob.result_bytes)
    # Over HTTP, .npy bodies through the port's client into both.
    data, st = client.run(stacks[1], result_format="ply")
    jdata, jst = jclient.run(stacks[1], result_format="ply")
    assert st["status"] == jst["status"] == "done"
    assert st["result"] == jst["result"]
    _same_cloud(data, jdata)
    _same_cloud(data, jobs[1][0].result_bytes)


def test_stl_results_match_jax(services, stacks, tmp_path):
    port, jax_svc, _ = services
    job = _done(port, stacks[0], result_format="stl")
    jjob = _done(jax_svc, stacks[0], result_format="stl")
    assert job.result_meta["points"] == jjob.result_meta["points"]
    assert abs(job.result_meta["faces"] - jjob.result_meta["faces"]) \
        <= 1e-3 * jjob.result_meta["faces"]
    (tmp_path / "p.stl").write_bytes(job.result_bytes)
    (tmp_path / "j.stl").write_bytes(jjob.result_bytes)
    mesh = stl.read_stl(str(tmp_path / "p.stl"))
    jmesh = jstl.read_stl(str(tmp_path / "j.stl"))
    assert len(mesh.faces) == job.result_meta["faces"]
    assert len(jmesh.faces) == jjob.result_meta["faces"]
    assert np.isfinite(mesh.vertices).all()


def test_program_cache_misses_are_buckets_times_batches(services, stacks):
    """Warmup builds every (bucket, batch) program once; steady traffic
    builds none, by the cache's counters and by the compile telemetry."""
    from structured_light_for_3d_model_replication_tpu_torch.utils import (
        sanitize,
    )

    port, jax_svc, _ = services
    want = len(port.config.buckets) * len(BATCH_SIZES)
    assert port.cache.stats()["misses"] == want
    assert jax_svc.cache.stats()["misses"] == want
    assert port.telemetry.compiles_total >= want
    before = port.cache.stats()
    with sanitize.no_compile_region("serve-steady-state"):
        jobs = [port.submit_array(stacks[i % 4]) for i in range(10)]
        for j in jobs:
            assert j.wait(WAIT_S) and j.status == "done"
    after = port.cache.stats()
    assert after["misses"] == want and after["hits"] > before["hits"]
    assert after["evictions"] == 0


def test_batch_occupancy_above_one_under_concurrent_submits(stacks):
    """Jobs admitted together coalesce: eight submits from four threads
    into a fresh service run in batches of mean occupancy > 1."""
    svc = ReconstructionService(_config(ServeConfig, PROJ, linger_ms=200.0),
                                calib_provider=carried_provider()).start()
    try:
        jobs, lock = [], threading.Lock()
        gate = threading.Barrier(4, timeout=WAIT_S)

        def submit(i):
            gate.wait()
            for k in range(2):
                j = svc.submit_array(stacks[(i + k) % 4])
                with lock:
                    jobs.append(j)

        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
            assert not t.is_alive()
        for j in jobs:
            assert j.wait(WAIT_S) and j.status == "done", j.status_dict()
        occ = svc.registry.histogram("serve_batch_occupancy").snapshot()
        assert occ["count"] < len(jobs) and occ["mean"] > 1.0, occ
    finally:
        assert svc.drain(timeout=WAIT_S)


def test_black_stack_contained_as_in_jax(services, stacks):
    port, jax_svc, _ = services
    out = []
    for svc in (port, jax_svc):
        good = [svc.submit_array(s) for s in stacks[:2]]
        bad = svc.submit_array(np.zeros_like(stacks[0]))
        for j in good + [bad]:
            assert j.wait(WAIT_S)
        assert [j.status for j in good] == ["done", "done"]
        err = bad.status_dict()["error"]
        out.append((bad.status, err["type"], err["taxonomy"]))
        _done(svc, stacks[2])                   # still serving
    assert out[0] == out[1]
    assert out[0][:2] == ("failed", "StopQualityError")
    assert "ScanFault" in out[0][2]


def test_http_backpressure_429_with_retry_after(stacks):
    svc = ReconstructionService(_config(ServeConfig, PROJ, queue_depth=2,
                                        batch_sizes=(1,), warmup=False),
                                calib_provider=carried_provider())
    http = ServeHTTPServer(svc, port=0).start()   # workers never started
    client = ServeClient(f"http://127.0.0.1:{http.port}", retries=0)
    try:
        client.submit(stacks[0])
        client.submit(stacks[1])
        with pytest.raises(BackpressureError) as ei:
            client.submit(stacks[2])
        assert ei.value.retry_after_s and ei.value.retry_after_s > 0
        assert client.healthz()["queue_depth"] == 2
        assert client.readyz()["ready"] is False
        with pytest.raises(QueueFullError):
            svc.submit_array(stacks[3])
    finally:
        http.stop()


def test_program_cache_lru_and_pinned_placement():
    """The port's cache on the CPU: LRU eviction and counters as the JAX
    cache counts them, the calibration placed once per bucket, and a CPU
    batch staged as the host array itself."""
    tiny = ProjectorConfig(width=16, height=8)

    def key(h, w):
        return ProgramKey(bucket=BucketKey(
            height=h, width=w, frames=tiny.n_frames, col_bits=tiny.col_bits,
            row_bits=tiny.row_bits), batch=1)

    cache = ProgramCache(synthetic_calib_provider(tiny, "cpu"),
                         max_entries=2, registry=trace.MetricsRegistry(),
                         device="cpu")
    keys = [key(8, 8), key(8, 16), key(16, 16)]
    for k in keys:
        cache.get(k)
    st = cache.stats()
    assert (st["misses"], st["hits"], st["evictions"], st["size"]) == \
        (3, 0, 1, 2)
    assert keys[0].label() not in st["entries"]
    cache.get(keys[2])
    cache.get(keys[0])
    st = cache.stats()
    assert st["hits"] == 1 and st["misses"] == 4
    assert cache.placed_calib(keys[1]) is cache.placed_calib(keys[1])
    batch = np.ones((1, tiny.n_frames, 8, 16), np.uint8)
    staged = cache.stage(keys[1], batch)
    assert staged.device.type == "cpu" and np.array_equal(staged.numpy(),
                                                          batch)
    with pytest.raises(NotImplementedError, match="step 4"):
        cache.device_for(ProgramKey(bucket=keys[0].bucket, batch=1,
                                    shards=2))


def test_service_needs_a_card_and_refuses_fleet_options(monkeypatch,
                                                        tmp_path):
    """No fallback: the default device is the card, and without one the
    service raises. The fleet tier's options now start a replica (its
    peer cache built, its handoff stream open); what runs across cards
    raises NotImplementedError naming step 4(c)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ReconstructionService(ServeConfig(proj=PROJ, buckets=((H, W),)))
    peered = ReconstructionService(_config(
        ServeConfig, PROJ, content_cache=True,
        peers=("http://127.0.0.1:1",)))
    assert peered.peer_cache.peer_urls == ["http://127.0.0.1:1"]
    handoff = ReconstructionService(_config(
        ServeConfig, PROJ, handoff_dir=str(tmp_path / "handoff"),
        store_dir=str(tmp_path / "store"), warmup=False)).start()
    try:
        assert handoff.handoff is not None
        assert handoff.handoff.list_sessions() == []
    finally:
        assert handoff.drain(timeout=WAIT_S)
    for bad in (dict(shard_min_pixels=1), dict(devices=2)):
        with pytest.raises(NotImplementedError, match=r"step 4\(c\)"):
            ReconstructionService(_config(ServeConfig, PROJ, **bad))


def test_cli_serve_fleet_options_exit_2(capsys, tmp_path):
    """``--router`` without ``--replicas`` and ``--handoff-dir`` without
    ``--store-dir`` exit 2 as the JAX tool does; a replica with
    ``--peers`` and ``--handoff-dir`` starts (tests/test_torch_router.py
    runs the router itself); the multi-card options exit 2 naming step
    4(c)."""
    import subprocess
    import sys

    from structured_light_for_3d_model_replication_tpu_torch.cli import (
        serve as cli_serve,
    )

    assert cli_serve.main(["--router"]) == 2
    assert "--router requires --replicas" in capsys.readouterr().err
    assert cli_serve.main(["--handoff-dir", str(tmp_path / "h"),
                           "--device", "cpu"]) == 2
    assert "requires --store-dir" in capsys.readouterr().err
    for argv in (["--shard-min-pixels", "1"], ["--devices", "2"]):
        assert cli_serve.main(argv + ["--device", "cpu"]) == 2
        assert "step 4(c)" in capsys.readouterr().err
    args = cli_serve.build_parser().parse_args([])
    assert args.device == "cuda" and args.queue_depth == \
        ServeConfig().queue_depth
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "structured_light_for_3d_model_replication_tpu_torch.cli", "serve",
         "--device", "cpu", "--port", "0", "--proj-width", "64",
         "--proj-height", "32", "--buckets", f"{H}x{W}", "--batch-sizes",
         "1", "--no-warmup", "--store-dir", str(tmp_path / "store"),
         "--handoff-dir", str(tmp_path / "handoff"), "--peers",
         "http://127.0.0.1:1", "--replica-id", "r-cli"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        stderr=subprocess.PIPE, text=True)
    try:
        lines, up = [], threading.Event()

        def pump():
            for line in proc.stderr:
                lines.append(line)
                if "serving on :" in line:
                    up.set()
            up.set()

        threading.Thread(target=pump, daemon=True).start()
        assert up.wait(WAIT_S) and lines and "serving on :" in lines[-1], \
            "".join(lines[-20:])
        port = int(lines[-1].rsplit(":", 1)[1])
        health = ServeClient(f"http://127.0.0.1:{port}",
                             timeout_s=WAIT_S).healthz()
        assert health["replica_id"] == "r-cli"
        proc.terminate()
        assert proc.wait(timeout=WAIT_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
