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
                 "io.layout"):
        assert f"{PORT}.{name}" in out, name


def test_entry_modules_do_not_load_kernel_bindings():
    _run(f"""
        import sys
        from {PORT}.models import scan360, pipeline, synthetic, meshing
        from {PORT}.ops import decode, nn, registration, tsdf
        from {PORT}.ops import (brickknn, brickknn_kernel, cluster,
                                features_brick, gridknn, pointcloud,
                                segmentation)
        from {PORT}.io import layout, ply
        from {PORT} import fusion, stream
        from {PORT}.stream import session
        loaded = [m for m in sys.modules if m.startswith("{PORT}.kernels")
                  or m == "triton"]
        assert not loaded, loaded
    """)


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
