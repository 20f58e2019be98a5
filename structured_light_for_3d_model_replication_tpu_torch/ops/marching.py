"""Iso-surface extraction: vectorized marching tetrahedra on the host
(counterpart of the JAX ``ops/marching.py``, NumPy only).

The oracle every device result is held against, and the extractor of the
dense (depth ≤ 8) path: the field is pulled to the host, sign-change cells
are found with one comparison pass, and all triangle math is batched array
ops. Marching *tetrahedra* (6 tets per cube): 16 cases that collapse to
"1 inside → 1 triangle, 2 inside → 2 triangles". Winding is made globally
consistent by voting triangle normals against the field gradient.

``extract_sparse(engine=...)`` also dispatches to the device extractor
(:mod:`.marching_device`), which ``"auto"`` picks for a grid on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.stl import TriangleMesh


def _np(x) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# Cube corner offsets, index = bit order used below.
_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], dtype=np.int64)

# Standard 6-tetrahedron decomposition of the cube around diagonal 0-6.
_TETS = np.array(
    [[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
     [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]], dtype=np.int64)


def _interp(p_a, v_a, p_b, v_b, iso):
    """Linear iso crossing on edge a→b. Inputs (M,3)/(M,) arrays."""
    denom = v_b - v_a
    t = np.where(np.abs(denom) > 1e-12, (iso - v_a) / np.where(
        np.abs(denom) > 1e-12, denom, 1.0), 0.5)
    t = np.clip(t, 0.0, 1.0)[:, None]
    return p_a + t * (p_b - p_a)


def _tet_triangles(P, V, iso):
    """Triangles from a batch of tets. P: (M,4,3) corner positions,
    V: (M,4) values. Returns (T,3,3) triangle soup (grid coords)."""
    inside = V > iso                      # (M, 4)
    k = inside.sum(axis=1)
    tris = []

    # --- one vertex on its own side (k==1 lone inside, k==3 lone outside) ---
    for lone_inside in (True, False):
        sel = (k == 1) if lone_inside else (k == 3)
        if not sel.any():
            continue
        Ps, Vs, ins = P[sel], V[sel], inside[sel]
        lone = np.argmax(ins if lone_inside else ~ins, axis=1)     # (m,)
        m = Ps.shape[0]
        rows = np.arange(m)
        others = np.array([[b for b in range(4) if b != a] for a in range(4)],
                          dtype=np.int64)[lone]                    # (m, 3)
        pa, va = Ps[rows, lone], Vs[rows, lone]
        q = [_interp(pa, va, Ps[rows, others[:, j]],
                     Vs[rows, others[:, j]], iso) for j in range(3)]
        tris.append(np.stack([q[0], q[1], q[2]], axis=1))

    # --- two/two split: quad → two triangles ---
    sel = k == 2
    if sel.any():
        Ps, Vs, ins = P[sel], V[sel], inside[sel]
        m = Ps.shape[0]
        rows = np.arange(m)
        order = np.argsort(~ins, axis=1, kind="stable")  # inside first
        a, b = order[:, 0], order[:, 1]   # inside pair
        c, d = order[:, 2], order[:, 3]   # outside pair
        pac = _interp(Ps[rows, a], Vs[rows, a], Ps[rows, c], Vs[rows, c], iso)
        pad = _interp(Ps[rows, a], Vs[rows, a], Ps[rows, d], Vs[rows, d], iso)
        pbc = _interp(Ps[rows, b], Vs[rows, b], Ps[rows, c], Vs[rows, c], iso)
        pbd = _interp(Ps[rows, b], Vs[rows, b], Ps[rows, d], Vs[rows, d], iso)
        tris.append(np.stack([pac, pad, pbd], axis=1))
        tris.append(np.stack([pac, pbd, pbc], axis=1))

    if not tris:
        return np.zeros((0, 3, 3), np.float64)
    return np.concatenate(tris, axis=0)


def extract_triangles(chi: np.ndarray, iso: float):
    """Marching tetrahedra over the active cells of a (R,R,R) field.

    Returns a (T,3,3) float64 triangle soup in grid coordinates.
    """
    chi = np.asarray(chi, np.float64)
    R = chi.shape[0]
    inside = chi > iso
    # A cell is active iff its 8 corners are not all on one side.
    c = inside[:-1, :-1, :-1]
    all_in = c.copy()
    any_in = c.copy()
    for dx, dy, dz in _CORNERS[1:]:
        blk = inside[dx:R - 1 + dx, dy:R - 1 + dy, dz:R - 1 + dz]
        all_in &= blk
        any_in |= blk
    active = np.argwhere(any_in & ~all_in)                # (A, 3)
    if active.shape[0] == 0:
        return np.zeros((0, 3, 3), np.float64)

    corner_idx = active[:, None, :] + _CORNERS[None]      # (A, 8, 3)
    vals = chi[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]
    pos = corner_idx.astype(np.float64)                   # grid coords

    P = pos[:, _TETS, :].reshape(-1, 4, 3)                # (A*6, 4, 3)
    V = vals[:, _TETS].reshape(-1, 4)
    return _tet_triangles(P, V, iso)


def orient_triangles(tris: np.ndarray, chi: np.ndarray,
                     outward_high: bool | None = None) -> np.ndarray:
    """Make winding globally consistent (and outward) by checking each
    triangle's normal against the field gradient at its centroid."""
    if tris.shape[0] == 0:
        return tris
    cen = tris.mean(axis=1)
    R = chi.shape[0]
    ic = np.clip(np.round(cen).astype(np.int64), 1, R - 2)
    grad = np.stack([
        chi[ic[:, 0] + 1, ic[:, 1], ic[:, 2]] - chi[ic[:, 0] - 1, ic[:, 1], ic[:, 2]],
        chi[ic[:, 0], ic[:, 1] + 1, ic[:, 2]] - chi[ic[:, 0], ic[:, 1] - 1, ic[:, 2]],
        chi[ic[:, 0], ic[:, 1], ic[:, 2] + 1] - chi[ic[:, 0], ic[:, 1], ic[:, 2] - 1],
    ], axis=1)
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    agree = np.einsum("ij,ij->i", n, grad)
    if outward_high is None:
        # Global vote: scanned objects are star-ish around their centroid, so
        # outward ≈ away from the soup centroid. Decide which gradient sign
        # that corresponds to by majority.
        out_dir = cen - cen.mean(axis=0)
        vote = np.einsum("ij,ij->i", n, out_dir)
        flip_field = np.sum(np.sign(agree) * np.sign(vote)) < 0
    else:
        flip_field = not outward_high
    want_positive = not flip_field
    flip = (agree < 0) if want_positive else (agree > 0)
    tris = tris.copy()
    tris[flip] = tris[flip][:, ::-1, :]
    return tris


def weld(tris: np.ndarray, decimals: int = 6):
    """Triangle soup → indexed (vertices, faces) by exact-rounded merging."""
    flat = tris.reshape(-1, 3)
    key = np.round(flat, decimals)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)
    # Drop degenerate faces produced by welding.
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    return uniq.astype(np.float32), faces[good]


class _SparseSampler:
    """Vectorized global-voxel → value lookup over (M,8,8,8) bricks."""

    def __init__(self, bricks: np.ndarray, coords: np.ndarray,
                 fill: float):
        bs = bricks.shape[1]
        self.bs = bs
        self.bricks = bricks
        self.fill = fill
        key = (coords[:, 0].astype(np.int64) << 42) \
            | (coords[:, 1].astype(np.int64) << 21) | coords[:, 2]
        self.order = np.argsort(key)
        self.sorted_keys = key[self.order]

    def block_index(self, bc: np.ndarray) -> np.ndarray:
        """(..., 3) block coords → brick row (−1 when absent)."""
        key = (bc[..., 0].astype(np.int64) << 42) \
            | (bc[..., 1].astype(np.int64) << 21) | bc[..., 2]
        pos = np.searchsorted(self.sorted_keys, key)
        pos_c = np.minimum(pos, len(self.sorted_keys) - 1)
        found = self.sorted_keys[pos_c] == key
        return np.where(found, self.order[pos_c], -1)

    def __call__(self, vox: np.ndarray) -> np.ndarray:
        """(..., 3) int global voxel coords → field values (fill outside)."""
        bc = vox >> 3 if self.bs == 8 else vox // self.bs
        intra = vox - bc * self.bs
        idx = self.block_index(bc)
        safe = np.maximum(idx, 0)
        vals = self.bricks[safe, intra[..., 0], intra[..., 1],
                           intra[..., 2]]
        return np.where(idx >= 0, vals, self.fill)


def extract_sparse(grid, quantile_trim: float = 0.0,
                   engine: str = "auto") -> TriangleMesh:
    """SparsePoissonGrid → welded TriangleMesh in world coordinates.

    The band-sparse sibling of :func:`extract`: marches only the active
    blocks of :func:`..ops.poisson_sparse.reconstruct_sparse` (at depth 10
    that is ~1% of the virtual 1024³ grid). Cross-block cells read their
    +1 corner values from the neighboring brick; at the outer band edge
    corners clamp to the block face (equal-value cells produce no
    crossings — the band is dilated a full block past the samples, so the
    surface cannot reach it).

    ``engine`` selects the extractor: ``"host"`` — this module's NumPy
    path (the oracle); ``"device"`` — the on-device path
    (:func:`.marching_device.extract_sparse_device`, needs ``grid.nbr``);
    ``"auto"`` — device when the grid lies on a CUDA card and carries its
    neighbour table, host otherwise (a CPU grid stays on the oracle).
    """
    if engine not in ("auto", "host", "device"):
        raise ValueError(f"unknown extraction engine {engine!r}")
    if engine == "device" or (engine == "auto" and grid.nbr is not None
                              and grid.chi.device.type == "cuda"):
        from . import marching_device

        return marching_device.extract_sparse_device(
            grid, quantile_trim=quantile_trim)
    valid = _np(grid.block_valid)
    # Brick fields arrive FLAT (M, BS³) — the TPU-tiling-friendly layout
    # (see SparsePoissonGrid) — and get their 3-D shape back on host.
    bs_side = round(grid.chi.shape[-1] ** (1.0 / 3.0))
    chi = _np(grid.chi).astype(np.float64)[valid].reshape(
        -1, bs_side, bs_side, bs_side)
    density = _np(grid.density).astype(np.float64)[valid].reshape(
        -1, bs_side, bs_side, bs_side)
    coords = _np(grid.block_coords)[valid]
    iso = float(grid.iso)
    mv = chi.shape[0]
    if mv == 0:
        return TriangleMesh(np.zeros((0, 3), np.float32),
                            np.zeros((0, 3), np.int32))
    bs = chi.shape[1]

    samp_chi = _SparseSampler(chi, coords, fill=iso)
    samp_den = _SparseSampler(density, coords, fill=0.0)

    # (Mv, 9, 9, 9) corner field: brick + 7 neighbor fills.
    C = np.empty((mv, bs + 1, bs + 1, bs + 1), np.float64)
    C[:, :bs, :bs, :bs] = chi

    def nb_vals(offset, face):
        """Values of the neighbor brick at ``offset`` on our ``face``
        slice, clamp-filled when absent."""
        idx = samp_chi.block_index(coords + np.asarray(offset))
        safe = np.maximum(idx, 0)
        vals = chi[safe][tuple([slice(None)] + face)]
        here_face = [slice(None)] + [
            (bs - 1 if o == 1 else slice(None)) for o in offset]
        clamp = chi[tuple(here_face)]
        m = (idx >= 0).reshape((-1,) + (1,) * (vals.ndim - 1))
        return np.where(m, vals, clamp)

    C[:, bs, :bs, :bs] = nb_vals((1, 0, 0), [0, slice(None), slice(None)])
    C[:, :bs, bs, :bs] = nb_vals((0, 1, 0), [slice(None), 0, slice(None)])
    C[:, :bs, :bs, bs] = nb_vals((0, 0, 1), [slice(None), slice(None), 0])
    C[:, bs, bs, :bs] = nb_vals((1, 1, 0), [0, 0, slice(None)])
    C[:, bs, :bs, bs] = nb_vals((1, 0, 1), [0, slice(None), 0])
    C[:, :bs, bs, bs] = nb_vals((0, 1, 1), [slice(None), 0, 0])
    C[:, bs, bs, bs] = nb_vals((1, 1, 1), [0, 0, 0])

    inside = C > iso
    cell0 = inside[:, :bs, :bs, :bs]
    all_in = cell0.copy()
    any_in = cell0.copy()
    for dx, dy, dz in _CORNERS[1:]:
        blk = inside[:, dx:bs + dx, dy:bs + dy, dz:bs + dz]
        all_in &= blk
        any_in |= blk
    active = np.argwhere(any_in & ~all_in)               # (A, 4) b,x,y,z
    if active.shape[0] == 0:
        return TriangleMesh(np.zeros((0, 3), np.float32),
                            np.zeros((0, 3), np.int32))

    b = active[:, 0]
    cell = active[:, 1:]
    corner_local = cell[:, None, :] + _CORNERS[None]     # (A, 8, 3)
    vals = C[b[:, None], corner_local[..., 0], corner_local[..., 1],
             corner_local[..., 2]]
    pos = (coords[b][:, None, :] * bs + corner_local).astype(np.float64)

    P = pos[:, _TETS, :].reshape(-1, 4, 3)
    V = vals[:, _TETS].reshape(-1, 4)
    tris = _tet_triangles(P, V, iso)
    if tris.shape[0] == 0:
        return TriangleMesh(np.zeros((0, 3), np.float32),
                            np.zeros((0, 3), np.int32))

    # Orientation: field gradient at each centroid via the sparse sampler.
    cen = tris.mean(axis=1)
    ic = np.round(cen).astype(np.int64)
    R = grid.resolution
    ic = np.clip(ic, 1, R - 2)
    ex = np.array([1, 0, 0])
    ey = np.array([0, 1, 0])
    ez = np.array([0, 0, 1])
    grad = np.stack([samp_chi(ic + ex) - samp_chi(ic - ex),
                     samp_chi(ic + ey) - samp_chi(ic - ey),
                     samp_chi(ic + ez) - samp_chi(ic - ez)], axis=1)
    nrm = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    agree = np.einsum("ij,ij->i", nrm, grad)
    out_dir = cen - cen.mean(axis=0)
    vote = np.einsum("ij,ij->i", nrm, out_dir)
    want_positive = np.sum(np.sign(agree) * np.sign(vote)) >= 0
    flip = (agree < 0) if want_positive else (agree > 0)
    tris[flip] = tris[flip][:, ::-1, :]

    if quantile_trim > 0.0 and tris.shape[0]:
        d = samp_den(np.clip(np.round(tris.mean(axis=1)).astype(np.int64),
                             0, R - 1))
        keep = d > np.quantile(d, quantile_trim)
        tris = tris[keep]

    verts, faces = weld(tris)
    world = verts * float(grid.scale) + _np(grid.origin).astype(np.float32)
    mesh = TriangleMesh(world.astype(np.float32), faces)
    if len(mesh.faces):
        mesh.compute_vertex_normals()
    return mesh


def extract(grid, quantile_trim: float = 0.0) -> TriangleMesh:
    """PoissonGrid → welded TriangleMesh in world coordinates.

    ``quantile_trim`` q drops triangles whose splat density falls in the
    bottom q quantile — the reference's density trim
    (`server/processing.py:214-218,297-302`); q=0 keeps the mesh watertight
    (the GUI default, `server/gui.py:65`).
    """
    chi = _np(grid.chi).astype(np.float64)
    density = _np(grid.density).astype(np.float64)
    iso = float(grid.iso)
    tris = extract_triangles(chi, iso)
    tris = orient_triangles(tris, chi)
    if quantile_trim > 0.0 and tris.shape[0]:
        cen = np.clip(np.round(tris.mean(axis=1)).astype(np.int64), 0,
                      chi.shape[0] - 1)
        d = density[cen[:, 0], cen[:, 1], cen[:, 2]]
        keep = d > np.quantile(d, quantile_trim)
        tris = tris[keep]
    verts, faces = weld(tris)
    world = verts * float(grid.scale) + _np(grid.origin).astype(np.float32)
    mesh = TriangleMesh(world.astype(np.float32), faces)
    if len(mesh.faces):
        mesh.compute_vertex_normals()
    return mesh
