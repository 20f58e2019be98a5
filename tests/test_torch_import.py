"""The PyTorch port stands alone: it imports without JAX and without the JAX
package, never imports its CUDA bindings eagerly, and its entry points
refuse to drop to the CPU on their own.

The import checks run in a fresh interpreter (a subprocess): this test
process already holds jax, imported by tests/conftest.py.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu_torch.models import (
    pipeline,
    scan360,
)
from structured_light_for_3d_model_replication_tpu_torch.ops import patterns
from structured_light_for_3d_model_replication_tpu_torch.ops.triangulate import (
    calibration_from_numpy,
    make_calibration,
)

REPO = Path(__file__).resolve().parents[1]
PORT = "structured_light_for_3d_model_replication_tpu_torch"
JAX_PKG = "structured_light_for_3d_model_replication_tpu"


def _run(code: str) -> str:
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120, check=False)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_every_port_module_imports_without_jax():
    """Import every module of the port; neither ``jax`` nor any module of
    the JAX package may be loaded. The port's name starts with the JAX
    package's, so the check is on the exact name or its ``name.`` prefix."""
    out = _run(f"""
        import importlib, pkgutil, sys
        import {PORT} as port
        names = [m.name for m in pkgutil.walk_packages(
            port.__path__, port.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith("jax.")
               or m == "{JAX_PKG}" or m.startswith("{JAX_PKG}.")]
        print(len(names), bad, names)
        assert not bad, bad
    """)
    n_modules = int(out.split()[0])
    assert n_modules >= 20
    for name in ("ops.brickknn", "ops.brickknn_kernel", "ops.gridknn",
                 "ops.segmentation", "ops.cluster", "ops.features_brick",
                 "io.layout", "io.png", "ops.splat_render",
                 "ops.splat_composite", "splat", "splat.model", "splat.fit",
                 "splat.preview", "_native", "io._fileobj", "io.images",
                 "io.matcal", "models.realism", "cli", "cli.__main__",
                 "cli.process_cloud", "cli.read_calib", "cli.merge_360",
                 "cli.scan_360", "cli.mesh", "cli.render", "cli.serve",
                 "calibration", "hw", "hw.faults", "utils.log",
                 "utils.events", "utils.trace", "utils.telemetry",
                 "utils.sanitize", "stream.warmup", "serve", "serve.jobs",
                 "serve.batcher", "serve.governor", "serve.tenants",
                 "serve.blobstore", "serve.store", "serve.client",
                 "serve.cache", "serve.worker", "serve.lanes",
                 "serve.sessions", "serve.service", "serve.fleet",
                 "serve.router", "cli.diagnose", "hw.camera",
                 "hw.command_server", "hw.projector", "hw.rig",
                 "hw.turntable", "scanner", "viz", "gui", "cli.scan",
                 "cli.view", "analysis", "analysis.core",
                 "analysis.callgraph", "analysis.locks", "analysis.project",
                 "analysis.rules", "analysis.rules_concurrency",
                 "analysis.__main__", "cli.lint"):
        assert f"{PORT}.{name}" in out, name


def test_entry_modules_do_not_load_kernel_bindings():
    _run(f"""
        import sys
        from {PORT}.models import scan360, pipeline, synthetic, meshing
        from {PORT}.ops import decode, nn, registration, tsdf
        from {PORT}.ops import (brickknn, brickknn_kernel, cluster,
                                features_brick, gridknn, pointcloud,
                                segmentation)
        from {PORT}.io import layout, ply, png
        from {PORT} import fusion, splat, stream
        from {PORT}.ops import splat_composite, splat_render
        from {PORT}.splat import fit, model, preview
        from {PORT}.stream import session
        from {PORT} import _native, cli
        from {PORT}.cli import (merge_360, mesh, process_cloud, read_calib,
                                render, scan_360)
        from {PORT}.io import _fileobj, images, matcal
        from {PORT}.models import realism
        from {PORT} import calibration, serve
        from {PORT}.cli import serve as cli_serve
        from {PORT}.cli import diagnose
        from {PORT}.serve import fleet, router
        from {PORT}.hw import faults
        from {PORT}.stream import warmup
        from {PORT}.utils import events, log, sanitize, telemetry, trace
        loaded = [m for m in sys.modules if m.startswith("{PORT}.kernels")
                  or m == "triton"]
        assert not loaded, loaded
        # Importing the native bindings builds nothing.
        assert _native._lib is None and not _native._tried
    """)


def test_capture_and_view_modules_load_no_optional_imports():
    """The capture loop and the viewer import nothing optional: no
    ``tkinter`` (the GUI builds its root in ``main``), no ``cv2`` (the
    window projector and the webcam import it in their constructors), no
    ``serial`` (the ESP32 driver's constructor), no JAX, no kernel
    bindings."""
    _run(f"""
        import sys
        from {PORT} import gui, hw, scanner, viz
        from {PORT}.cli import scan, view
        from {PORT}.hw import (camera, command_server, projector, rig,
                               turntable)
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("tkinter", "_tkinter", "cv2", "serial", "jax", "triton")
               or m.startswith("{PORT}.kernels")
               or m == "{JAX_PKG}" or m.startswith("{JAX_PKG}.")]
        assert not bad, bad
    """)


def test_lint_loads_no_kernel_binding_and_no_jax():
    """``cli lint`` runs in a fresh interpreter over a clean tree and loads
    no kernel binding, no ``triton``, no ``torch.cuda`` extension module
    and nothing of JAX: the analysis is stdlib-only, so it does not even
    load ``torch``."""
    out = _run(f"""
        import os, sys, tempfile
        from {PORT} import cli
        with tempfile.TemporaryDirectory() as tmp:
            with open(os.path.join(tmp, "mod.py"), "w") as f:
                f.write("x = 1\\n")
            rc = cli.main(["lint", tmp, "-q"])
        bad = [m for m in sys.modules
               if m.startswith("{PORT}.kernels") or m == "triton"
               or m == "torch" or m.startswith("torch.cuda") or m.startswith("torch._C._cuda")
               or m == "jax" or m.startswith("jax.")
               or m == "{JAX_PKG}" or m.startswith("{JAX_PKG}.")]
        print(rc, bad)
        assert rc == 0 and not bad, (rc, bad)
        assert any(m == "{PORT}.analysis.rules" for m in sys.modules)
    """)
    assert out.splitlines()[-1].split()[0] == "0"


def test_entry_points_raise_without_cuda(monkeypatch):
    """``device=None`` means the card; with no card the entry points raise
    instead of quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    eye = np.eye(3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_calibration(eye, eye, eye, np.zeros(3), 4, 4, 8, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        patterns.pattern_stack(8, 4, 3, 2)
    calib = make_calibration(eye, eye, eye, np.zeros(3), 4, 4, 8, 8,
                             device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calibration_from_numpy({k: v.numpy() for k, v in
                                calib._asdict().items()})
    stack = np.zeros((12, 4, 4), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.reconstruct(stack, calib, 3, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        scan360.scan_stacks_to_cloud(np.stack([stack, stack]), calib, 3, 2)
    # The same calls run when the caller asks for the CPU.
    res = pipeline.reconstruct(stack, calib, 3, 2, device="cpu")
    assert res.points.shape == (16, 3) and res.points.device.type == "cpu"


def test_slice_entry_points_raise_without_cuda(monkeypatch):
    """The mesh and streaming entry points: ``device=None`` raises without a
    card; ``device="cpu"`` runs."""
    from structured_light_for_3d_model_replication_tpu_torch.fusion import (
        TSDFParams,
        TSDFVolume,
    )
    from structured_light_for_3d_model_replication_tpu_torch.io.ply import (
        PointCloud,
    )
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        meshing,
    )
    from structured_light_for_3d_model_replication_tpu_torch.stream import (
        IncrementalSession,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    u = rng.normal(size=(400, 3)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)

    def cloud():
        return PointCloud(points=u * 10.0, normals=u.copy())

    eye = np.eye(3)
    calib = make_calibration(eye, eye, eye, np.zeros(3), 4, 4, 8, 8,
                             device="cpu")
    params = TSDFParams(grid_depth=5, max_bricks=64)
    for call in (lambda: meshing.mesh_from_cloud(cloud(), depth=5),
                 lambda: meshing.mesh_360(cloud(), os.devnull, depth=5),
                 lambda: TSDFVolume(params, np.zeros(3), 1.0),
                 lambda: IncrementalSession(calib, 3, 2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    mesh = meshing.mesh_from_cloud(cloud(), depth=5, device="cpu")
    assert len(mesh.faces) > 0
    assert len(meshing.mesh_360(cloud(), os.devnull, depth=5,
                                device="cpu").faces) > 0
    vol = TSDFVolume(params, np.full(3, -12.0), 0.75, device="cpu")
    assert vol.state.tsdf.device.type == "cpu"
    sess = IncrementalSession(calib, 3, 2, device="cpu")
    assert sess.device.type == "cpu" and sess.stops_fused == 0


def test_cleanup_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """The cleanup workflows and the file-level merges: ``device=None``
    raises without a card; ``device="cpu"`` runs."""
    from structured_light_for_3d_model_replication_tpu_torch.io.ply import (
        PointCloud,
        write_ply,
    )
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        merge,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(1)
    cloud = PointCloud(points=rng.normal(size=(300, 3)).astype(np.float32))
    for i in range(2):
        write_ply(str(tmp_path / f"s{i}.ply"), cloud)
    calls = (lambda: merge.remove_background(cloud),
             lambda: merge.remove_outliers(cloud),
             lambda: merge.register_pair_clouds(cloud, cloud),
             lambda: merge.merge_pro_360([cloud, cloud]),
             lambda: merge.merge_posegraph_360([cloud, cloud]),
             lambda: merge.merge_360_files(str(tmp_path),
                                           str(tmp_path / "out.ply")))
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert len(merge.remove_outliers(cloud, device="cpu")) > 250
    assert len(merge.remove_background(cloud, num_iterations=64,
                                       device="cpu")) < 300


def test_composite_refuses_gradients_and_splat_entry_points_need_a_card(
        monkeypatch):
    """The composite kernel has no backward: its wrapper raises on inputs
    that require gradients, on every device, instead of detaching them. The
    splat entry points take ``device=None`` as the card and raise without
    one; ``device="cpu"`` runs."""
    from structured_light_for_3d_model_replication_tpu_torch.io.ply import (
        PointCloud,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        splat_composite,
        splat_render,
    )
    from structured_light_for_3d_model_replication_tpu_torch.splat import (
        SplatParams,
        SplatScene,
        splat_scene_from_cloud,
    )

    rec = torch.zeros((3, 5))
    org = torch.zeros(3)
    planes = [rec.clone() for _ in range(10)]
    for i in (0, 5, 8):
        grad = list(planes)
        grad[i] = rec.clone().requires_grad_(True)
        with pytest.raises(ValueError, match="requires grad"):
            splat_composite.composite(*grad, org, org, 4)
    with pytest.raises(ValueError, match="requires grad"):
        splat_composite.composite(*planes, org.clone().requires_grad_(True),
                                  org, 4)
    assert splat_composite.composite(*planes, org, org, 4)[1].shape == (3,
                                                                        16)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(2)
    u = rng.normal(size=(600, 3)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    arrays = (u, u, np.zeros((600, 3), np.float32),
              np.zeros((600, 4, 3), np.float32), np.zeros(600, np.float32),
              np.ones(600, bool))
    cam = splat_render.orbit_camera(u.min(0), u.max(0), 0, 0, 32, 24)
    cfg = splat_render.RenderConfig(32, 24)
    for call in (lambda: splat_render.render(*arrays, cam, cfg),
                 lambda: SplatScene.from_numpy(SplatParams(600), *arrays),
                 lambda: splat_scene_from_cloud(PointCloud(points=u,
                                                           normals=u))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    img, alpha = splat_render.render(*arrays, cam, cfg, device="cpu")
    assert img.shape == (24, 32, 3) and float(alpha.max()) > 0.0


def test_serve_and_calibration_entry_points_raise_without_cuda(monkeypatch):
    """The serving replica, its session warm-up and the corner decode:
    ``device=None`` means the card and raises without one."""
    from structured_light_for_3d_model_replication_tpu_torch import (
        calibration,
    )
    from structured_light_for_3d_model_replication_tpu_torch.config import (
        ProjectorConfig,
    )
    from structured_light_for_3d_model_replication_tpu_torch.serve import (
        ProgramCache,
        ReconstructionService,
        ServeConfig,
    )
    from structured_light_for_3d_model_replication_tpu_torch.stream import (
        StreamParams,
        warm_session_programs,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    proj = ProjectorConfig(width=16, height=8)
    corners = np.zeros((4, 1, 2), np.float32)
    calls = (lambda: ReconstructionService(ServeConfig(proj=proj)),
             lambda: ProgramCache(lambda h, w: None),
             lambda: warm_session_programs(StreamParams(), 64),
             lambda: calibration.decode_at_corners(
                 np.zeros((proj.n_frames, 4, 4), np.uint8), corners, proj))
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    uv = calibration.decode_at_corners(
        np.zeros((proj.n_frames, 4, 4), np.uint8), corners, proj,
        device="cpu")
    assert uv.shape == (4, 2) and uv.dtype == np.float32


def test_fleet_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """A fleet replica (``cli serve`` with ``--peers`` and
    ``--handoff-dir``) defaults to the card and raises without one; the
    router runs no device code, so it starts and stops without a card."""
    from structured_light_for_3d_model_replication_tpu_torch.cli import (
        serve as cli_serve,
    )
    from structured_light_for_3d_model_replication_tpu_torch.serve import (
        FleetRouter,
        RouterHTTPServer,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_serve.main(["--port", "0", "--no-warmup", "--store-dir",
                        str(tmp_path / "s"), "--handoff-dir",
                        str(tmp_path / "h"), "--peers",
                        "http://127.0.0.1:1"])
    router = FleetRouter(["http://127.0.0.1:1"], check_interval_s=999.0)
    http = RouterHTTPServer(router, port=0).start()
    try:
        assert router.ready_replicas() == []
    finally:
        http.stop()
