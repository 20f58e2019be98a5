"""The PyTorch port stands alone: it imports without JAX and without the JAX
package, never imports its CUDA bindings eagerly, and its entry points
refuse to drop to the CPU on their own.

The import checks run in a fresh interpreter (a subprocess): this test
process already holds jax, imported by tests/conftest.py.
"""

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
        print(len(names), bad)
        assert not bad, bad
    """)
    n_modules = int(out.split()[0])
    assert n_modules >= 20


def test_entry_modules_do_not_load_kernel_bindings():
    _run(f"""
        import sys
        from {PORT}.models import scan360, pipeline, synthetic
        from {PORT}.ops import decode, nn, registration
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
