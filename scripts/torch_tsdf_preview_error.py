"""How far a TSDF preview's surface lies from the truth on exact points,
JAX package against the PyTorch port.

A parity harness, like the ``tests/test_torch_*.py`` files: it imports both
packages and runs on the host CPU. It samples the half of a sphere (radius
80 mm, centre 500 mm in front of the camera) that faces the camera, with no
noise, integrates it from the camera into each package's ``TSDFVolume``
(grid depth 8, 16,384 bricks, the streaming previews' settings) at a given
voxel, extracts the mesh and prints, per package and voxel, the faces and
the median and mean signed distance of the vertices to the sphere. It is
the yardstick for the previews' accuracy that ``chip_smoke.py`` phase 8i (b)
compares the carved previews with.

    python scripts/torch_tsdf_preview_error.py [--voxels 6 3] [--points 20000]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from structured_light_for_3d_model_replication_tpu.fusion.volume import (  # noqa: E402
    TSDFVolume as JaxVolume,
)
from structured_light_for_3d_model_replication_tpu.ops.tsdf import (  # noqa: E402
    TSDFParams as JaxParams,
)
from structured_light_for_3d_model_replication_tpu_torch.fusion.volume import (  # noqa: E402
    TSDFVolume,
)
from structured_light_for_3d_model_replication_tpu_torch.ops.tsdf import (  # noqa: E402
    TSDFParams,
)

CENTRE = np.array([0.0, 0.0, 500.0], np.float32)
RADIUS = 80.0


def visible_sphere(n: int, seed: int) -> np.ndarray:
    """Points on the sphere's camera-facing half (camera at the origin)."""
    d = np.random.default_rng(seed).normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (CENTRE + RADIUS * d).astype(np.float32)
    return pts[(-pts * d).sum(1) > 0]


def preview_error(pts: np.ndarray, voxel: float, package: str) -> dict:
    m = len(pts)
    col = np.full((m, 3), 128, np.float32)
    val = np.ones(m, bool)
    cam = np.zeros(3, np.float32)
    lo, hi = pts.min(0), pts.max(0)
    if package == "jax":
        vol = JaxVolume.from_bounds(JaxParams(grid_depth=8, max_bricks=16384),
                                    lo, hi, pad_frac=0.6)
        conv = jnp.asarray
    else:
        vol = TSDFVolume.from_bounds(TSDFParams(grid_depth=8,
                                                max_bricks=16384),
                                     lo, hi, pad_frac=0.6, device="cpu")
        conv = torch.from_numpy
    vol.voxel_size = voxel
    vol.integrate_from_camera(conv(pts), conv(col), conv(val), conv(cam))
    mesh = vol.extract()
    v = np.asarray(mesh.vertices, np.float64)
    signed = np.linalg.norm(v - CENTRE, axis=1) - RADIUS
    return {"package": package, "voxel_mm": voxel, "faces": len(mesh.faces),
            "median_mm": float(np.median(np.abs(signed))),
            "median_voxels": float(np.median(np.abs(signed)) / voxel),
            "mean_signed_mm": float(signed.mean())}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--voxels", type=float, nargs="+", default=[6.0, 3.0])
    ap.add_argument("--points", type=int, default=20_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    pts = visible_sphere(args.points, args.seed)
    rows = [preview_error(pts, v, pkg) for v in args.voxels
            for pkg in ("torch", "jax")]
    for r in rows:
        print(r, flush=True)
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
