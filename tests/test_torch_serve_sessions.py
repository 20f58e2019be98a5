"""Streaming sessions through one serving replica: a 3-stop session over
HTTP through the port's service and the JAX package's, on the 4-stop small
rig of tests/test_torch_stream.py (camera 96×160, projector 256×128, its
STREAM session settings and its FAST merge settings with fewer RANSAC
hypotheses, ICP steps and registration points), on the CPU; then a
splat-lane session's ``GET /session/<id>/render`` and ``render_png``
finalize on the port's, and ``POST /session {"expected_stops": 4}`` in
both with the tenant's refund after a failed create in the port's.

Tolerances (tests/test_torch_stream.py's session contract): every stop
fused in both, each stop's decision, coverage and fused-model size equal,
its edge fitness within 1e-3; the final cloud's point count within 2% and
the final STL's face count within 1% of the JAX package's (1,384 against
1,385 points and 23,580 against 23,562 faces here: the RANSAC streams
differ, so the poses differ within 0.5° and the clouds and meshes built
from them by that much), > 100 faces. Every wait has its own bound.
"""

import os

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
from structured_light_for_3d_model_replication_tpu.serve.service import (
    synthetic_calib_provider as jsynthetic_calib_provider,
)
from structured_light_for_3d_model_replication_tpu.stream import (
    StreamParams as JStreamParams,
)
from structured_light_for_3d_model_replication_tpu_torch import serve
from structured_light_for_3d_model_replication_tpu_torch.config import (
    ProjectorConfig,
)
from structured_light_for_3d_model_replication_tpu_torch.io import stl
from structured_light_for_3d_model_replication_tpu_torch.io.png import (
    decode_png,
)
from structured_light_for_3d_model_replication_tpu_torch.models import (
    merge,
    synthetic,
)
from structured_light_for_3d_model_replication_tpu_torch.ops.triangulate import (
    calibration_from_numpy,
)
from structured_light_for_3d_model_replication_tpu_torch.stream import (
    StreamParams,
)

from .conftest import CAM_H, CAM_W, SMALL_PROJ

WAIT_S = 180.0
SPHERES = ((0.0, 10.0, 500.0, 80.0, 0.9), (60.0, -40.0, 460.0, 35.0, 0.7),
           (-70.0, 40.0, 530.0, 30.0, 0.8), (20.0, 70.0, 440.0, 25.0, 0.75))
FAST = dict(voxel_size=6.0, ransac_iterations=512, icp_iterations=10,
            fpfh_max_nn=24, normals_k=12, max_points=1024,
            posegraph_iterations=20, step_deg=10.0, final_max_points=4096)
STREAM = dict(method="posegraph", view_cap=8192, preview_points=2048,
              preview_depth=5, final_depth=6, model_cap=32_768, window=3,
              tsdf_grid_depth=6, tsdf_max_bricks=1024)
SPLAT = dict(representation="splat", preview_every=0, splat_cap=2048,
             splat_fit_iters=4, splat_fit_pixels=960,
             splat_render_sizes=((96, 72),))
JPROJ = JProjectorConfig(width=SMALL_PROJ.width, height=SMALL_PROJ.height,
                         brightness=SMALL_PROJ.brightness)


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
    mats = synthetic.default_calibration(CAM_H, CAM_W, SMALL_PROJ)
    scene = synthetic.Scene(wall_z=None, spheres=tuple(
        synthetic.Sphere((x, y, z), r, a) for x, y, z, r, a in SPHERES))
    return [s for s, _ in synthetic.render_turntable_scans(
        scene, 4, 10.0, *mats, CAM_H, CAM_W, SMALL_PROJ)]


def _carried(h, w, _memo={}):
    """The JAX service's synthetic calibration, carried into the port."""
    if (h, w) not in _memo:
        jcal = jsynthetic_calib_provider(JPROJ)(h, w)
        _memo[(h, w)] = calibration_from_numpy(
            {k: np.asarray(v) for k, v in jcal._asdict().items()},
            device="cpu")
    return _memo[(h, w)]


def _port_service(cfg_kw=None, **stream):
    sp = StreamParams(merge=merge.MergeParams(**FAST),
                      **dict(STREAM, **stream))
    cfg = serve.ServeConfig(
        device="cpu", proj=ProjectorConfig(
            width=SMALL_PROJ.width, height=SMALL_PROJ.height,
            brightness=SMALL_PROJ.brightness),
        buckets=((CAM_H, CAM_W),), batch_sizes=(1,), linger_ms=1.0,
        workers=1, stream=sp, warmup_sessions=False, content_cache=False,
        **(cfg_kw or {}))
    return serve.ReconstructionService(cfg, calib_provider=_carried).start()


def _jax_service(**cfg_kw):
    sp = JStreamParams(merge=jmerge.MergeParams(**FAST),
                       **dict(STREAM, preview_every=0))
    cfg = jserve.ServeConfig(
        proj=JPROJ, buckets=((CAM_H, CAM_W),), batch_sizes=(1,),
        linger_ms=1.0, workers=1, stream=sp, warmup_sessions=False,
        content_cache=False, **cfg_kw)
    return jserve.ReconstructionService(cfg).start()


def _run_session(svc, stacks, tmp_path, name):
    """Three stops and an STL finalize over HTTP through the port's
    client; returns (stop metas, finalize meta, mesh)."""
    http = serve.ServeHTTPServer(svc, port=0).start()
    client = serve.ServeClient(f"http://127.0.0.1:{http.port}", retries=0)
    try:
        sid = client.create_session()
        metas = []
        for k in range(3):
            st = client.wait(client.submit_stop(sid, stacks[k]),
                             timeout_s=WAIT_S)
            assert st["status"] == "done", st
            metas.append(st["result"])
        fin = client.finalize_session(sid, "stl")
        st = client.wait(fin["job_id"], timeout_s=WAIT_S)
        assert st["status"] == "done", st
        path = tmp_path / f"{name}.stl"
        path.write_bytes(client.result(fin["job_id"]))
        return metas, st["result"], stl.read_stl(str(path))
    finally:
        http.stop()
        assert svc.drain(timeout=WAIT_S)


def test_session_over_http_matches_jax(stacks, tmp_path):
    # Previews off in both: they are not compared, and their first
    # programs are most of the JAX session's cost on the CPU.
    port = _run_session(_port_service(preview_every=0), stacks, tmp_path,
                        "port")
    jax_ = _run_session(_jax_service(), stacks, tmp_path, "jax")
    for m, jm in zip(port[0], jax_[0]):
        assert m["fused"] == jm["fused"] is True
        for k in ("reason", "coverage", "model_points", "gap"):
            assert m[k] == jm[k], (k, m, jm)
        if jm["fitness"] is not None:
            assert abs(m["fitness"] - jm["fitness"]) <= 1e-3
    fin, jfin = port[1], jax_[1]
    assert fin["stops_fused"] == jfin["stops_fused"] == 3
    assert fin["stops_skipped"] == jfin["stops_skipped"] == 0
    assert abs(fin["points"] - jfin["points"]) <= 0.02 * jfin["points"]
    assert abs(fin["faces"] - jfin["faces"]) <= 0.01 * jfin["faces"]
    assert len(port[2].faces) == fin["faces"] > 100
    assert np.isfinite(port[2].vertices).all()


def _tokens(svc) -> float:
    return svc.tenants.stats()["tokens"]["anon"]


def test_session_options_and_failed_create_refund():
    """``POST /session {"expected_stops": 4}`` opens a session in both
    packages (the port once answered 400: its ``StreamParams`` lacked the
    field), and in the port a create that fails for any reason gives the
    tenant's admission back (a 400, the token count where it was; at
    1e-3 tokens/s the bucket refills < 0.05 a token within the test)."""
    quota = dict(tenant_rate_per_s=1e-3, tenant_burst=8)
    port = _port_service(quota, preview_every=0)
    jax_ = _jax_service(**quota)
    for svc, client_mod in ((port, serve), (jax_, jserve)):
        http = client_mod.ServeHTTPServer(svc, port=0).start()
        client = client_mod.ServeClient(f"http://127.0.0.1:{http.port}",
                                        retries=0)
        try:
            sid = client.create_session(expected_stops=4)
            entry = svc.sessions.get(sid)
            assert entry.session.params.expected_stops == 4
            if svc is not port:
                continue
            before = _tokens(svc)
            assert before <= 7.0 + 0.05

            def boom(options=None, **kw):
                raise RuntimeError("made to fail")

            real = svc.sessions.create
            svc.sessions.create = boom
            try:
                with pytest.raises(serve.client.ServeClientError,
                                   match="400"):
                    client.create_session(expected_stops=4)
            finally:
                svc.sessions.create = real
            assert abs(_tokens(svc) - before) < 0.05
            # A create that succeeds spends its token.
            assert client.create_session(preview_depth=5)
            assert _tokens(svc) < before - 0.9
        finally:
            http.stop()
            assert svc.drain(timeout=WAIT_S)


def test_splat_session_render_png(stacks):
    """The splat lane through the service: a live ``render`` of the asked
    size, ``render_png`` as the finalize artifact, and a size off the
    configured menu refused."""
    svc = _port_service(**SPLAT)
    http = serve.ServeHTTPServer(svc, port=0).start()
    client = serve.ServeClient(f"http://127.0.0.1:{http.port}", retries=0)
    try:
        sid = client.create_session()
        for k in range(3):
            st = client.wait(client.submit_stop(sid, stacks[k]),
                             timeout_s=WAIT_S)
            assert st["status"] == "done" and st["result"]["fused"], st
        data, meta = client.render(sid, 30.0, 20.0, size=(96, 72))
        img = decode_png(data)
        assert img.shape == (72, 96, 3) and img.any()
        assert int(meta["render_splats"]) > 100
        with pytest.raises(serve.client.ServeClientError):
            client.render(sid, 30.0, 20.0, size=(97, 72))
        fin = client.finalize_session(sid, "render_png")
        st = client.wait(fin["job_id"], timeout_s=WAIT_S)
        assert st["status"] == "done", st
        png = decode_png(client.result(fin["job_id"]))
        assert png.shape == (72, 96, 3)
        assert st["result"]["width"] == 96 and st["result"]["height"] == 72
    finally:
        http.stop()
        assert svc.drain(timeout=WAIT_S)
