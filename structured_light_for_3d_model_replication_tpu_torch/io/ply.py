"""PLY point-cloud writer (copy of the JAX package's ``io/ply.py``
``PointCloud`` and ``write_ply``: binary_little_endian, or ASCII).

The reference's ASCII layout (x y z at %.4f + uchar red green blue) is the
default ASCII schema, so files interchange with clouds produced by the
reference. Colors are stored as given (RGB in, RGB out).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np


@dataclasses.dataclass
class PointCloud:
    """Host-side cloud container (``o3d.geometry.PointCloud`` analogue)."""

    points: np.ndarray                   # (N, 3) float32
    colors: np.ndarray | None = None     # (N, 3) uint8
    normals: np.ndarray | None = None    # (N, 3) float32

    def __len__(self) -> int:
        return int(self.points.shape[0])


@contextlib.contextmanager
def _binary_sink(path_or_file):
    if hasattr(path_or_file, "write"):
        yield path_or_file
    else:
        with open(path_or_file, "wb") as f:
            yield f


def write_ply(path, cloud: PointCloud, binary: bool = True) -> None:
    """Write a point cloud. Binary little-endian by default; ASCII matches the
    reference's schema (xyz %.4f + uchar rgb). ``path`` is a filesystem path
    or an open binary file object."""
    pts = np.asarray(cloud.points, np.float32)
    n = pts.shape[0]
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    header_props = ["property float x", "property float y", "property float z"]
    if cloud.normals is not None:
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
        header_props += ["property float nx", "property float ny",
                         "property float nz"]
    if cloud.colors is not None:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        header_props += ["property uchar red", "property uchar green",
                         "property uchar blue"]

    header = (
        "ply\n"
        f"format {'binary_little_endian' if binary else 'ascii'} 1.0\n"
        f"element vertex {n}\n" + "\n".join(header_props) + "\nend_header\n"
    )

    with _binary_sink(path) as f:
        f.write(header.encode())
        if binary:
            rec = np.empty(n, dtype=np.dtype(fields))
            rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
            if cloud.normals is not None:
                nrm = np.asarray(cloud.normals, np.float32)
                rec["nx"], rec["ny"], rec["nz"] = nrm[:, 0], nrm[:, 1], nrm[:, 2]
            if cloud.colors is not None:
                col = np.asarray(cloud.colors, np.uint8)
                rec["red"], rec["green"], rec["blue"] = (
                    col[:, 0], col[:, 1], col[:, 2])
            f.write(rec.data)
        else:
            parts = ["%.4f %.4f %.4f"]
            arrays = [pts]
            if cloud.normals is not None:
                parts.append("%.4f %.4f %.4f")
                arrays.append(np.asarray(cloud.normals, np.float32))
            if cloud.colors is not None:
                parts.append("%d %d %d")
                arrays.append(np.asarray(cloud.colors))
            full = np.concatenate([a.astype(np.float64) for a in arrays], axis=1)
            np.savetxt(f, full, fmt=" ".join(parts))
