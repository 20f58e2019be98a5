"""PLY codec (copy of the JAX package's ``io/ply.py``: the ``PointCloud``
reader and writer, and the triangle-mesh writer and reader that carry
per-vertex normals and colours — a coloured mesh has no other file format;
binary_little_endian, or ASCII).

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


_PLY_TO_NP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


@contextlib.contextmanager
def _binary_sink(path_or_file):
    if hasattr(path_or_file, "write"):
        yield path_or_file
    else:
        with open(path_or_file, "wb") as f:
            yield f


@contextlib.contextmanager
def _binary_source(path_or_file):
    if hasattr(path_or_file, "read"):
        yield path_or_file
    else:
        with open(path_or_file, "rb") as f:
            yield f


def _parse_header(f):
    """Returns (fmt, elements) after end_header; each element is (name,
    count, [(type, name) or ("list", count_type, item_type, name), ...])."""
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements = []
    cur = None
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        tok = line.strip().split()
        if not tok or tok[0] == b"comment":
            continue
        if tok[0] == b"format":
            fmt = tok[1].decode()
        elif tok[0] == b"element":
            cur = (tok[1].decode(), int(tok[2]), [])
            elements.append(cur)
        elif tok[0] == b"property":
            if tok[1] == b"list":
                cur[2].append(("list", tok[2].decode(), tok[3].decode(),
                               tok[4].decode()))
            else:
                cur[2].append((tok[1].decode(), tok[2].decode()))
        elif tok[0] == b"end_header":
            break
    return fmt, elements


def read_ply(path) -> PointCloud:
    """Read a PLY point cloud (the vertex element; any other element is
    skipped). ``path`` is a filesystem path or an open binary file
    object."""
    with _binary_source(path) as f:
        fmt, elements = _parse_header(f)
        vertex = next((e for e in elements if e[0] == "vertex"), None)
        if vertex is None:
            raise ValueError(f"{path}: no vertex element")
        _, n, props = vertex
        if any(p[0] == "list" for p in props):
            raise ValueError("list property on vertex element unsupported")
        names = [p[1] for p in props]
        if fmt == "ascii":
            # The vertex element comes first in every writer we read.
            raw = np.loadtxt(f, dtype=np.float64, max_rows=n, ndmin=2)
            cols = {nm: raw[:, i] for i, nm in enumerate(names)}
        elif fmt == "binary_little_endian":
            dt = np.dtype([(nm, "<" + _PLY_TO_NP[t]) for t, nm in props])
            raw = np.frombuffer(f.read(dt.itemsize * n), dtype=dt, count=n)
            cols = {nm: raw[nm] for nm in names}
        else:
            raise ValueError(f"unsupported PLY format {fmt!r}")
    pts = np.stack([cols["x"], cols["y"], cols["z"]], axis=-1).astype(
        np.float32)
    colors = normals = None
    if all(c in cols for c in ("red", "green", "blue")):
        colors = np.stack([cols["red"], cols["green"], cols["blue"]],
                          axis=-1).astype(np.uint8)
    if all(c in cols for c in ("nx", "ny", "nz")):
        normals = np.stack([cols["nx"], cols["ny"], cols["nz"]],
                           axis=-1).astype(np.float32)
    return PointCloud(pts, colors, normals)


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


# ---------------------------------------------------------------------------
# Triangle meshes (vertex + face elements): the vertex-coloured mesh carrier
# STL cannot be
# ---------------------------------------------------------------------------


def write_ply_mesh(path, mesh, binary: bool = True) -> None:
    """Write a :class:`..io.stl.TriangleMesh` as PLY (vertex + face
    elements), carrying per-vertex normals and RGB when present. ``path`` is
    a filesystem path or an open binary file object."""
    v = np.asarray(mesh.vertices, np.float32)
    faces = np.asarray(mesh.faces, np.int32)
    n, nf = v.shape[0], faces.shape[0]
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    props = ["property float x", "property float y", "property float z"]
    normals = getattr(mesh, "vertex_normals", None)
    colors = getattr(mesh, "vertex_colors", None)
    if normals is not None:
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
        props += ["property float nx", "property float ny",
                  "property float nz"]
    if colors is not None:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        props += ["property uchar red", "property uchar green",
                  "property uchar blue"]
    header = (
        "ply\n"
        f"format {'binary_little_endian' if binary else 'ascii'} 1.0\n"
        f"element vertex {n}\n" + "\n".join(props) + "\n"
        f"element face {nf}\n"
        "property list uchar int vertex_indices\nend_header\n"
    )
    with _binary_sink(path) as f:
        f.write(header.encode())
        if binary:
            rec = np.empty(n, dtype=np.dtype(fields))
            rec["x"], rec["y"], rec["z"] = v[:, 0], v[:, 1], v[:, 2]
            if normals is not None:
                nr = np.asarray(normals, np.float32)
                rec["nx"], rec["ny"], rec["nz"] = nr[:, 0], nr[:, 1], \
                    nr[:, 2]
            if colors is not None:
                c = np.asarray(colors, np.uint8)
                rec["red"], rec["green"], rec["blue"] = c[:, 0], c[:, 1], \
                    c[:, 2]
            f.write(rec.data)
            frec = np.empty(nf, dtype=np.dtype([("n", "u1"),
                                                ("v", "<i4", (3,))]))
            frec["n"] = 3
            frec["v"] = faces
            f.write(frec.data)
        else:
            parts = ["%.6f %.6f %.6f"]
            arrays = [v.astype(np.float64)]
            if normals is not None:
                parts.append("%.4f %.4f %.4f")
                arrays.append(np.asarray(normals, np.float64))
            if colors is not None:
                parts.append("%d %d %d")
                arrays.append(np.asarray(colors, np.float64))
            np.savetxt(f, np.concatenate(arrays, axis=1),
                       fmt=" ".join(parts))
            np.savetxt(f, np.concatenate(
                [np.full((nf, 1), 3, np.int64),
                 faces.astype(np.int64)], axis=1), fmt="%d")


def read_ply_mesh(path):
    """Read a PLY triangle mesh (vertex + triangular face elements) into a
    :class:`..io.stl.TriangleMesh`, recovering per-vertex normals and RGB
    when present. Faces must be triangles."""
    from .stl import TriangleMesh

    with _binary_source(path) as f:
        fmt, elements = _parse_header(f)
        vertex = next((e for e in elements if e[0] == "vertex"), None)
        face = next((e for e in elements if e[0] == "face"), None)
        if vertex is None or face is None:
            raise ValueError(f"{path}: expected vertex + face elements")
        _, n, props = vertex
        for p in props:
            if p[0] == "list":
                raise ValueError(
                    f"{path}: list property on vertex element unsupported")
        names = [p[1] for p in props]
        _, nf, fprops = face
        flist = next((p for p in fprops if p[0] == "list"), None)
        if flist is None:
            raise ValueError(f"{path}: face element has no list property")
        if fmt == "ascii":
            vraw = np.loadtxt(f, dtype=np.float64, max_rows=n, ndmin=2)
            cols = {nm: vraw[:, i] for i, nm in enumerate(names)}
            fraw = np.loadtxt(f, dtype=np.int64, max_rows=nf, ndmin=2)
            if fraw.size and not np.all(fraw[:, 0] == 3):
                raise ValueError(f"{path}: non-triangle faces")
            faces = fraw[:, 1:4].astype(np.int32) if fraw.size else \
                np.zeros((0, 3), np.int32)
        elif fmt == "binary_little_endian":
            dt = np.dtype([(nm, "<" + _PLY_TO_NP[t]) for t, nm in props])
            vraw = np.frombuffer(f.read(dt.itemsize * n), dtype=dt, count=n)
            cols = {nm: vraw[nm] for nm in names}
            fdt = np.dtype([("n", _PLY_TO_NP[flist[1]]),
                            ("v", "<" + _PLY_TO_NP[flist[2]], (3,))])
            fraw = np.frombuffer(f.read(fdt.itemsize * nf), dtype=fdt,
                                 count=nf)
            if nf and not np.all(fraw["n"] == 3):
                raise ValueError(f"{path}: non-triangle faces")
            faces = fraw["v"].astype(np.int32)
        else:
            raise ValueError(f"unsupported PLY format {fmt!r}")

    verts = np.stack([cols["x"], cols["y"], cols["z"]],
                     axis=-1).astype(np.float32)
    mesh = TriangleMesh(vertices=verts, faces=faces)
    if all(k in cols for k in ("nx", "ny", "nz")):
        mesh.vertex_normals = np.stack(
            [cols["nx"], cols["ny"], cols["nz"]], axis=-1).astype(np.float32)
    if all(k in cols for k in ("red", "green", "blue")):
        mesh.vertex_colors = np.stack(
            [cols["red"], cols["green"], cols["blue"]], axis=-1).astype(
            np.uint8)
    return mesh
