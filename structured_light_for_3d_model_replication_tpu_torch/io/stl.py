"""STL mesh codec (copy of the JAX package's ``io/stl.py``: ``TriangleMesh``,
binary read/write, ASCII write).

Replaces ``o3d.io.write_triangle_mesh`` as used for the final printable
output (`server/processing.py:248,310`). Binary STL is the default; ASCII
is provided for inspection.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ._fileobj import binary_sink

_BIN_DT = np.dtype([
    ("normal", "<f4", (3,)),
    ("v0", "<f4", (3,)),
    ("v1", "<f4", (3,)),
    ("v2", "<f4", (3,)),
    ("attr", "<u2"),
])


@dataclasses.dataclass
class TriangleMesh:
    """Host-side mesh container (analogue of ``o3d.geometry.TriangleMesh``)."""

    vertices: np.ndarray                      # (V, 3) float32
    faces: np.ndarray                         # (F, 3) int32
    vertex_normals: np.ndarray | None = None  # (V, 3) float32
    vertex_colors: np.ndarray | None = None   # (V, 3) uint8

    def face_normals(self) -> np.ndarray:
        v = self.vertices
        f = self.faces
        n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        ln = np.linalg.norm(n, axis=-1, keepdims=True)
        return (n / np.maximum(ln, 1e-12)).astype(np.float32)

    def compute_vertex_normals(self) -> np.ndarray:
        """Area-weighted vertex normals (``compute_vertex_normals``,
        `server/processing.py:247,307`); also stored on self."""
        v = self.vertices
        f = self.faces
        fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        vn = np.zeros_like(v)
        for k in range(3):  # scatter-add, 3 passes
            np.add.at(vn, f[:, k], fn)
        ln = np.linalg.norm(vn, axis=-1, keepdims=True)
        self.vertex_normals = (vn / np.maximum(ln, 1e-12)).astype(np.float32)
        return self.vertex_normals


def write_stl(path, mesh: TriangleMesh, binary: bool = True) -> None:
    """``path`` is a filesystem path or (binary mode only) an open binary
    file object — the serving layer streams STL results straight to HTTP
    responses."""
    v = np.asarray(mesh.vertices, np.float32)
    f = np.asarray(mesh.faces, np.int64)
    fn = mesh.face_normals()
    if binary:
        rec = np.zeros(f.shape[0], dtype=_BIN_DT)
        rec["normal"] = fn
        rec["v0"] = v[f[:, 0]]
        rec["v1"] = v[f[:, 1]]
        rec["v2"] = v[f[:, 2]]
        with binary_sink(path) as out:
            out.write(b"\0" * 80)
            out.write(np.uint32(f.shape[0]).tobytes())
            # Buffer-protocol write, not tofile: the sink may be an
            # in-memory buffer, and rec.data avoids tobytes's full
            # transient copy (~50 MB on a 1M-face mesh).
            out.write(rec.data)
    else:
        with open(path, "w") as out:
            out.write("solid mesh\n")
            tri = v[f]  # (F, 3, 3)
            for i in range(f.shape[0]):
                out.write(f"facet normal {fn[i,0]:e} {fn[i,1]:e} {fn[i,2]:e}\n"
                          "  outer loop\n")
                for k in range(3):
                    out.write(f"    vertex {tri[i,k,0]:e} {tri[i,k,1]:e} "
                              f"{tri[i,k,2]:e}\n")
                out.write("  endloop\nendfacet\n")
            out.write("endsolid mesh\n")


def read_stl(path: str) -> TriangleMesh:
    """Read a binary or ASCII STL. Duplicate vertices are merged exactly
    (bit-equal), so a write/read roundtrip restores shared topology."""
    with open(path, "rb") as f:
        head = f.read(80)
        # ASCII files start with 'solid' AND contain 'facet' soon after; some
        # binary writers also start the comment header with 'solid'.
        if head[:5] == b"solid" and b"facet" in head + f.read(200):
            return _read_stl_ascii(path)
        f.seek(80)
        n = int(np.frombuffer(f.read(4), "<u4")[0])
        rec = np.fromfile(f, dtype=_BIN_DT, count=n)
        if rec.shape[0] != n:
            raise ValueError(
                f"{path}: truncated binary STL ({rec.shape[0]}/{n} facets)")
    tris = np.stack([rec["v0"], rec["v1"], rec["v2"]], axis=1)  # (F, 3, 3)
    return _mesh_from_tris(tris)


def _mesh_from_tris(tris: np.ndarray) -> TriangleMesh:
    flat = np.ascontiguousarray(tris.reshape(-1, 3), np.float32)
    merged = _merge_rows(flat)
    if merged is None:
        verts, inv = np.unique(flat.view([("", "<f4")] * 3),
                               return_inverse=True)
        merged = verts.view("<f4").reshape(-1, 3), inv
    vertices, inv = merged
    faces = inv.reshape(-1, 3).astype(np.int32)
    return TriangleMesh(vertices.astype(np.float32), faces)


def _merge_rows(flat: np.ndarray):
    """The distinct rows of (N, 3) float32 ``flat`` and each row's index
    among them, as ``np.unique`` gives them for the structured view (rows
    ordered by x, then y, then z, as floats), by one lexsort of integer
    keys: ``np.unique`` sorts by comparing the structured rows field by
    field, which dominates the read of a mesh of millions of faces. None
    where that result is not determined by the values alone — no rows, a
    NaN, or rows equal as floats but not bit for bit (±0), whose
    representative ``np.unique`` takes from its own unstable sort."""
    if not len(flat) or np.isnan(flat).any():
        return None
    bits = np.where(flat == 0, np.float32(0), flat).view(np.uint32)
    # Float order as unsigned order: negatives flipped, positives lifted.
    key = np.where(bits >> 31 == 1, ~bits, bits | np.uint32(0x80000000))
    hi = key[:, 0].astype(np.uint64) << np.uint64(32) | key[:, 1]
    lo = key[:, 2]
    order = np.lexsort((lo, hi))
    hs, ls = hi[order], lo[order]
    new = np.empty(len(order), bool)
    new[0] = True
    new[1:] = (hs[1:] != hs[:-1]) | (ls[1:] != ls[:-1])
    group = np.cumsum(new) - 1
    raw = flat.view(np.uint32)[order]
    if not np.array_equal(raw, raw[new][group]):
        return None
    inv = np.empty(len(order), np.intp)
    inv[order] = group
    return flat[order[new]], inv


def _read_stl_ascii(path: str) -> TriangleMesh:
    verts = []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if tok and tok[0] == "vertex":
                verts.append([float(tok[1]), float(tok[2]), float(tok[3])])
    if len(verts) % 3:
        raise ValueError(f"{path}: ASCII STL vertex count not divisible by 3")
    return _mesh_from_tris(np.asarray(verts, np.float32).reshape(-1, 3, 3))
