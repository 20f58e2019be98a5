"""NumPy oracle pieces the port needs (copy of the JAX package's
``models/oracle.camera_rays_np``)."""

from __future__ import annotations

import numpy as np


def camera_rays_np(cam_K: np.ndarray, height: int, width: int) -> np.ndarray:
    """Unit viewing ray per camera pixel, (H, W, 3) float64."""
    uu, vv = np.meshgrid(np.arange(width, dtype=np.float64),
                         np.arange(height, dtype=np.float64))
    pix = np.stack([uu, vv, np.ones_like(uu)], axis=-1)
    rays = pix @ np.linalg.inv(cam_K).T
    return rays / np.linalg.norm(rays, axis=-1, keepdims=True)
