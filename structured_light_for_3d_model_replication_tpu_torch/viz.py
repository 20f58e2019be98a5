"""Offline visualization: point clouds and meshes rendered to PNG (the
port's copy of the JAX package's ``viz.py``, numpy kept as numpy: the same
inputs give the same images, bit for bit).

The reference's quality loop leans on interactive Open3D viewers at every
stage — inlier/outlier coloring (`Old/StatisticalOutlierRemoval.py:66-71`),
before/after pair alignment (`Old/New360.py:72-73`), plane-split preview
(`Old/blackground_remove.py:23`), and the final mesh (`Old/360Merge.py:125`,
`Old/new360Merge.py:190`). The port is headless (a card's host has no
display), so the equivalent is an offline renderer: numpy z-buffer splats
for clouds, batched barycentric rasterization for meshes, written to PNG by
a dependency-free encoder. Every reference "viewer moment" has a
corresponding helper here, wired to ``cli view`` and the GUI preview
buttons, and each is held to the JAX package's images in
``tests/test_torch_viz.py``.

All functions are pure host-side numpy: rendering is a debugging/preview
path, never on the device hot path.
"""

from __future__ import annotations

import numpy as np

# Default palette (RGB, 0-255). Matches the reference's viewer conventions:
# grey inliers / red outliers (`Old/StatisticalOutlierRemoval.py:66-68`),
# orange source / blue target for pairs (o3d example convention used by
# `Old/New360.py:63-66`).
INLIER_GREY = (200, 200, 200)
OUTLIER_RED = (230, 50, 40)
PAIR_ORANGE = (255, 166, 28)
PAIR_BLUE = (43, 120, 228)
PLANE_GREEN = (80, 200, 120)
MESH_BONE = (226, 221, 205)
BACKGROUND = (18, 20, 26)


# ----------------------------------------------------------------------
# PNG I/O: the shared stdlib-only encoder lives in `io/png.py` (the
# splat render endpoints and cli render need BYTES, not files); these
# wrappers keep the historical viz surface.
# ----------------------------------------------------------------------

def save_png(path, image: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an RGB PNG."""
    from .io.png import write_png

    write_png(path, image)


def load_png(path) -> np.ndarray:
    """Read back an RGB PNG written by :func:`save_png` (filter 0 only —
    round-trip/testing helper, not a general decoder)."""
    from .io.png import decode_png

    with open(path, "rb") as f:
        return decode_png(f.read())


# ----------------------------------------------------------------------
# Camera
# ----------------------------------------------------------------------

def _orbit_camera(points: np.ndarray, azim_deg: float, elev_deg: float,
                  zoom: float):
    """(R, eye, f_scale): world→camera rotation and eye position orbiting
    the cloud's bounding-sphere center. Camera looks +z at the center."""
    lo = np.min(points, axis=0)
    hi = np.max(points, axis=0)
    center = 0.5 * (lo + hi)
    radius = max(float(np.linalg.norm(hi - lo)) * 0.5, 1e-6)
    dist = zoom * radius

    az = np.deg2rad(azim_deg)
    el = np.deg2rad(elev_deg)
    # Eye on the orbit sphere; y is up (turntable axis convention).
    off = np.array([np.sin(az) * np.cos(el), np.sin(el),
                    -np.cos(az) * np.cos(el)])
    eye = center + dist * off
    fwd = center - eye
    fwd /= np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0])  # image +y down
    right = np.cross(fwd, up)
    nr = np.linalg.norm(right)
    if nr < 1e-9:  # looking straight along y
        right = np.array([1.0, 0.0, 0.0])
    else:
        right /= nr
    dn = np.cross(fwd, right)
    R = np.stack([right, -dn, fwd])  # rows: x, y, z of camera frame
    return R, eye, radius


def _project(points: np.ndarray, R, eye, width, height, fov_scale=1.15):
    """Project world points with the orbit pinhole. Returns (u, v, z, ok)."""
    pc = (points - eye) @ R.T
    z = pc[:, 2]
    ok = z > 1e-6
    zs = np.where(ok, z, 1.0)
    f = fov_scale * min(width, height) * 0.5
    u = pc[:, 0] / zs * f + (width - 1) * 0.5
    v = pc[:, 1] / zs * f + (height - 1) * 0.5
    ok &= (u > -2) & (u < width + 1) & (v > -2) & (v < height + 1)
    return u, v, z, ok


def _blank(width, height, bg):
    img = np.empty((height, width, 3), np.uint8)
    img[:] = np.asarray(bg, np.uint8)
    return img


def _splat(img, zbuf, u, v, z, colors, point_px):
    """Z-buffered square splats of ``point_px`` pixels."""
    h, w = img.shape[:2]
    ui = np.round(u).astype(np.int64)
    vi = np.round(v).astype(np.int64)
    r = range(-(point_px // 2), point_px - point_px // 2)
    for dy in r:
        for dx in r:
            x = ui + dx
            y = vi + dy
            inb = (x >= 0) & (x < w) & (y >= 0) & (y < h)
            flat = y[inb] * w + x[inb]
            zz = z[inb]
            cc = colors[inb]
            # Two-pass z-buffer: scatter-min depth, then write colors where
            # the depth matches the winner (ties resolved arbitrarily —
            # fine for previews).
            np.minimum.at(zbuf.reshape(-1), flat, zz)
            win = zbuf.reshape(-1)[flat] == zz
            img.reshape(-1, 3)[flat[win]] = cc[win]


def render_points(points, colors=None, *, width: int = 960,
                  height: int = 720, azim: float = 30.0, elev: float = 20.0,
                  zoom: float = 2.1, point_px: int = 2,
                  bg=BACKGROUND, camera=None) -> np.ndarray:
    """Render a point cloud to an (H, W, 3) uint8 image.

    ``colors``: (N, 3) uint8/float per-point colors, or None for depth-cued
    grey. Empty clouds render as background. ``camera``: optional
    precomputed ``(R, eye)`` pose overriding the per-cloud orbit fit — for
    multi-panel renders that must share one viewpoint (see
    :func:`render_pair`).
    """
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    img = _blank(width, height, bg)
    if pts.shape[0] == 0:
        return img
    if camera is None:
        R, eye, _ = _orbit_camera(pts, azim, elev, zoom)
    else:
        R, eye = camera
    u, v, z, ok = _project(pts, R, eye, width, height)
    if colors is None:
        # Depth cue: nearer → brighter.
        zn = (z - z.min()) / max(float(np.ptp(z)), 1e-9)
        g = (235 - 120 * zn).astype(np.uint8)
        cols = np.stack([g, g, g], axis=1)
    else:
        cols = np.asarray(colors)
        if cols.dtype != np.uint8:
            cols = np.clip(cols, 0, 255).astype(np.uint8)
        cols = np.broadcast_to(cols.reshape(-1, 3), pts.shape).copy()
    zbuf = np.full((height, width), np.inf, np.float64)
    _splat(img, zbuf, u[ok], v[ok], z[ok], cols[ok], point_px)
    return img


# ----------------------------------------------------------------------
# Mesh rendering: batched barycentric sample-splat with z-buffer.
# ----------------------------------------------------------------------

def render_mesh(vertices, faces, *, width: int = 960, height: int = 720,
                azim: float = 30.0, elev: float = 20.0, zoom: float = 2.1,
                color=MESH_BONE, bg=BACKGROUND) -> np.ndarray:
    """Render a triangle mesh with Lambert shading to (H, W, 3) uint8.

    Rasterization is vectorized sample-splatting: each face is covered by a
    G×G barycentric sample grid, G bucketed by the face's projected size so
    small faces stay cheap and large faces don't leave holes; samples are
    z-buffered square splats. Preview-grade (ties/edges are approximate),
    which is all the reference's viewer moments need.
    """
    verts = np.asarray(vertices, np.float64).reshape(-1, 3)
    tris = np.asarray(faces, np.int64).reshape(-1, 3)
    img = _blank(width, height, bg)
    if verts.shape[0] == 0 or tris.shape[0] == 0:
        return img
    R, eye, radius = _orbit_camera(verts, azim, elev, zoom)
    u, v, z, okv = _project(verts, R, eye, width, height)

    # Face shading: headlight Lambert + a little fill, on world normals.
    e1 = verts[tris[:, 1]] - verts[tris[:, 0]]
    e2 = verts[tris[:, 2]] - verts[tris[:, 0]]
    fn = np.cross(e1, e2)
    nn = np.linalg.norm(fn, axis=1, keepdims=True)
    fn = fn / np.maximum(nn, 1e-12)
    view = (verts[tris[:, 0]] + verts[tris[:, 1]] + verts[tris[:, 2]]) / 3.0
    vd = eye - view
    vd /= np.maximum(np.linalg.norm(vd, axis=1, keepdims=True), 1e-12)
    lam = np.abs(np.sum(fn * vd, axis=1))  # double-sided headlight
    key = np.array([0.25, 0.5, 0.83])  # a second light for shape reading
    lam2 = np.abs(fn @ key)
    shade = np.clip(0.18 + 0.66 * lam + 0.22 * lam2, 0.0, 1.0)
    base = np.asarray(color, np.float64)
    fcol = np.clip(shade[:, None] * base[None, :], 0, 255).astype(np.uint8)

    ok_f = okv[tris].all(axis=1)
    ut, vt, zt = u[tris], v[tris], z[tris]
    ext = np.maximum(ut.max(1) - ut.min(1), vt.max(1) - vt.min(1))

    zbuf = np.full((height, width), np.inf, np.float64)
    # Size buckets: G samples per edge ≈ projected pixel extent, so splat
    # coverage is gap-free at point_px=2.
    for g, lo, hi in ((2, 0.0, 3.0), (4, 3.0, 7.0), (8, 7.0, 15.0),
                      (16, 15.0, 31.0), (40, 31.0, np.inf)):
        sel = ok_f & (ext >= lo) & (ext < hi)
        if not np.any(sel):
            continue
        # Barycentric grid covering the triangle.
        a = np.linspace(0.0, 1.0, g + 1)
        bb, aa = np.meshgrid(a, a)
        keep = aa + bb <= 1.0 + 1e-9
        w0 = (1.0 - aa - bb)[keep]
        w1 = aa[keep]
        w2 = bb[keep]  # (S,)
        us = (ut[sel, 0, None] * w0 + ut[sel, 1, None] * w1
              + ut[sel, 2, None] * w2).ravel()
        vs = (vt[sel, 0, None] * w0 + vt[sel, 1, None] * w1
              + vt[sel, 2, None] * w2).ravel()
        zs = (zt[sel, 0, None] * w0 + zt[sel, 1, None] * w1
              + zt[sel, 2, None] * w2).ravel()
        cs = np.repeat(fcol[sel], w0.shape[0], axis=0)
        _splat(img, zbuf, us, vs, zs, cs, 2)
    return img


# ----------------------------------------------------------------------
# Reference "viewer moments"
# ----------------------------------------------------------------------

def render_inliers(points, keep_mask, **kw) -> np.ndarray:
    """Inlier/outlier coloring: grey survivors, red rejects — the offline
    twin of `Old/StatisticalOutlierRemoval.py:66-71`."""
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    keep = np.asarray(keep_mask, bool).reshape(-1)
    cols = np.where(keep[:, None], np.uint8(INLIER_GREY),
                    np.uint8(OUTLIER_RED))
    return render_points(pts, cols, **kw)


def render_plane_split(points, plane_mask, **kw) -> np.ndarray:
    """Plane-segmentation preview: plane green, object grey — the offline
    twin of `Old/blackground_remove.py:23`."""
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    pm = np.asarray(plane_mask, bool).reshape(-1)
    cols = np.where(pm[:, None], np.uint8(PLANE_GREEN),
                    np.uint8(INLIER_GREY))
    return render_points(pts, cols, **kw)


def render_pair(source, target, transform=None, *, width: int = 1280,
                height: int = 480, point_px: int = 2, azim: float = 30.0,
                elev: float = 20.0, zoom: float = 2.1, **kw) -> np.ndarray:
    """Before/after registration panel — the offline twin of
    `Old/New360.py:72-73`.

    Left half: source (orange) and target (blue) as given. Right half: the
    same pair with ``transform`` (4×4, applied to source). With
    ``transform=None`` both halves show the raw pair. BOTH panels share one
    camera, fitted to the union of {source, moved source, target} — a
    per-panel orbit fit would change viewpoint/scale when the transform
    moves the source, making the halves incomparable.
    """
    src = np.asarray(source, np.float64).reshape(-1, 3)
    dst = np.asarray(target, np.float64).reshape(-1, 3)
    half_w = width // 2

    if transform is not None:
        t = np.asarray(transform, np.float64).reshape(4, 4)
        moved = src @ t[:3, :3].T + t[:3, 3]
    else:
        moved = src
    union = np.concatenate([src, moved, dst], axis=0)
    cam = None
    if union.shape[0]:
        R, eye, _ = _orbit_camera(union, azim, elev, zoom)
        cam = (R, eye)

    def panel(s):
        pts = np.concatenate([s, dst], axis=0)
        cols = np.concatenate(
            [np.tile(np.uint8(PAIR_ORANGE), (len(s), 1)),
             np.tile(np.uint8(PAIR_BLUE), (len(dst), 1))], axis=0)
        return render_points(pts, cols, width=half_w, height=height,
                             point_px=point_px, camera=cam, **kw)

    left = panel(src)
    right = panel(moved)
    out = np.concatenate([left, right], axis=1)
    out[:, half_w - 1:half_w + 1] = 90  # seam
    return out
