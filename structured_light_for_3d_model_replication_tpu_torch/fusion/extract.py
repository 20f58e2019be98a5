"""Vertex-coloured iso-surface extraction from a TSDF brick volume
(counterpart of the JAX ``fusion/extract.py``).

Reuses the port's device marching machinery (:mod:`..ops.marching_device`:
the corner maps and the 8-neighbour table behind the (M, 729) corner frame,
the prefix-sum cell compaction, the per-cell tet classification and the
tet tables) with two TSDF additions:

* an **observation mask**: a cell emits triangles only when all 8 of its
  corners carry integration weight (> ``min_weight``); unobserved space
  never interpolates, so open scenes extract as open surfaces;
* **colour interpolation**: the RGB corner frames ride the same gathers as
  the TSDF's, and each triangle vertex interpolates RGB with the ``t`` of
  its position.

Capacities are bucketed with a caller-set floor (``cells_floor`` /
``tris_floor``), which also bounds the readback: the triangle soup is read
back at full capacity and sliced on the host. The host tail (outward vote,
weight trim, weld carrying first-occurrence vertex colours) is the JAX
package's numpy code.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..io.stl import TriangleMesh
from ..ops import marching_device as md
from ..ops import tsdf as tsdf_ops
from ..ops.marching import _CORNERS
from ..ops.marching_classify import _CIDX

log = logging.getLogger(__name__)


def _frame(vals: torch.Tensor, rows: torch.Tensor, src: torch.Tensor,
           clamp: torch.Tensor | None) -> torch.Tensor:
    """(M, 512[, 3]) bricks → (M, 729[, 3]) corner frame through the
    (M, 729) source rows; an absent neighbour (row M) falls back to the own
    brick's clamp voxel (``clamp``) or to 0 (``clamp`` None)."""
    m = vals.shape[0]
    tail = vals.shape[2:]
    pad = torch.cat([vals, vals.new_zeros((1, md._V) + tail)])
    v = pad.reshape((-1,) + tail)[rows * md._V + src]
    fb = vals[:, clamp] if clamp is not None else torch.zeros_like(v)
    present = rows < m
    if tail:
        present = present[..., None]
    return torch.where(present, v, fb)


def _phase_frames(chi, weight, rgb, nbr, block_valid, min_weight: float):
    """Corner frames for χ and RGB + the observation-masked active-cell
    mask and its count. χ and RGB take the own-brick clamp where a
    neighbour is absent (no spurious crossings); weight takes 0 there (an
    absent neighbour is unobserved: its cells must not emit)."""
    dev = chi.device
    rows = md._nb8_table(nbr)[:, md._t(md._CASE9, dev)]        # (M, 729)
    src = md._t(md._SRC9, dev)[None, :]
    clamp = md._t(md._CLAMP9, dev)
    c9 = _frame(chi, rows, src, clamp)
    w9 = _frame(weight, rows, src, None)
    rgb9 = _frame(rgb, rows, src, clamp)
    inside = c9 > 0.0
    observed = w9 > float(min_weight)
    cidx = torch.from_numpy(_CIDX).to(dev)
    any_in = all_in = all_obs = None
    for j in range(8):
        blk = inside[:, cidx[:, j]]
        obs = observed[:, cidx[:, j]]
        any_in = blk if any_in is None else (any_in | blk)
        all_in = blk if all_in is None else (all_in & blk)
        all_obs = obs if all_obs is None else (all_obs & obs)
    active = any_in & ~all_in & all_obs & block_valid[:, None]
    return c9, rgb9, active, active.sum(dtype=torch.int32)


def _phase_triangles_colored(cells, rgb9, weight, block_coords, T: int):
    """``marching_device._phase_triangles`` with RGB interpolation: (tris
    (T, 3, 3) grid coords, colours (T, 3, 3), density (T,) = the cell's own
    integration weight); slots past the true count hold garbage."""
    bk, ck, v8, case = cells
    dev = v8.device
    nt = md._t(md._NTRI, dev)[case]                              # (K, 6)
    tv = (torch.arange(2, device=dev)[None, None, :]
          < nt[:, :, None]).reshape(-1)                          # (K·12,)
    src = md._compact(tv, T).clamp_min(0)
    k = src // 12
    t = (src % 12) // 2
    j = src % 2
    case_t = case[k, t]
    epc = md._t(md._EP_CUBE, dev)[t, case_t, j]                  # (T, 3, 2)
    v8k = v8[k]
    va = torch.gather(v8k, 1, epc[:, :, 0])
    vb = torch.gather(v8k, 1, epc[:, :, 1])
    cidx = torch.from_numpy(_CIDX).to(dev)
    c8 = rgb9[bk[k][:, None], cidx[ck[k]]]                       # (T, 8, 3)
    ca = torch.gather(c8, 1, epc[:, :, 0, None].expand(-1, -1, 3))
    cb = torch.gather(c8, 1, epc[:, :, 1, None].expand(-1, -1, 3))
    base = (block_coords[bk[k]].to(torch.int64) * md.BS
            + md._t(md._CELL_XYZ, dev)[ck[k]])
    corners = md._t(_CORNERS, dev)
    pa = (base[:, None, :] + corners[epc[:, :, 0]]).to(torch.float32)
    pb = (base[:, None, :] + corners[epc[:, :, 1]]).to(torch.float32)
    denom = vb - va
    safe = denom.abs() > 1e-12
    tt = torch.where(safe, (0.0 - va) / torch.where(
        safe, denom, torch.ones((), device=dev)),
        torch.full((), 0.5, device=dev)).clamp(0.0, 1.0)
    tris = pa + tt[..., None] * (pb - pa)
    cols = ca + tt[..., None] * (cb - ca)
    flip = md._t(md._FLIP, dev)[t, case_t, j]
    tris = torch.where(flip[:, None, None], tris.flip(1), tris)
    cols = torch.where(flip[:, None, None], cols.flip(1), cols)
    return tris, cols, weight[bk[k], ck[k]]


def _weld_colored(tris: np.ndarray, cols: np.ndarray, decimals: int = 6):
    """``marching.weld`` with first-occurrence vertex colours carried through
    the rounded-vertex dedup."""
    flat = tris.reshape(-1, 3)
    key = np.round(flat, decimals)
    uniq, first, inv = np.unique(key, axis=0, return_index=True,
                                 return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    vcols = cols.reshape(-1, 3)[first]
    return uniq.astype(np.float32), faces[good], vcols


def _empty() -> TriangleMesh:
    return TriangleMesh(np.zeros((0, 3), np.float32),
                        np.zeros((0, 3), np.int32))


def extract_colored(state, params, origin, voxel_size,
                    min_weight: float = 0.0, quantile_trim: float = 0.0,
                    cells_floor: int = 4096, tris_floor: int = 8192,
                    with_colors: bool = True) -> TriangleMesh:
    """TSDF volume → welded vertex-coloured :class:`TriangleMesh`, on the
    volume's device up to the triangle soup.

    ``min_weight`` masks under-observed corners (0.0 = any observation
    counts); ``quantile_trim`` drops the lowest-weight triangle fraction.
    ``cells_floor``/``tris_floor`` are the compaction capacities' floors.
    An empty volume returns an empty mesh."""
    nbr, block_valid = tsdf_ops.neighbor_table(state, params)
    c9, rgb9, active, count = _phase_frames(
        state.tsdf, state.weight, state.rgb, nbr, block_valid, min_weight)
    n_cells = int(count)
    if n_cells == 0:
        return _empty()
    K = md._bucket(n_cells, floor=cells_floor)
    cell_ids = md._compact(active.reshape(-1), K)
    del active
    count_d, cells = md._phase_count(c9, cell_ids,
                                     torch.zeros((), device=c9.device))
    del c9
    nt = int(count_d)
    if nt == 0:
        return _empty()
    T = md._bucket(nt, floor=tris_floor)
    tris_d, cols_d, dens_d = _phase_triangles_colored(
        cells, rgb9, state.weight, state.brick_coords, T)
    tris = tris_d.cpu().numpy().astype(np.float64)[:nt]
    cols = cols_d.cpu().numpy().astype(np.float64)[:nt]
    dens = dens_d.cpu().numpy()[:nt]

    # Global outward decision: one all-or-nothing flip (the device winding
    # is already field-consistent).
    cen = tris.mean(axis=1)
    nrm = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    vote = np.einsum("ij,ij->i", nrm, cen - cen.mean(axis=0))
    if np.sum(np.sign(vote)) <= 0:
        tris = tris[:, ::-1, :]
        cols = cols[:, ::-1, :]
    if quantile_trim > 0.0 and tris.shape[0]:
        keep = dens > np.quantile(dens, quantile_trim)
        tris = tris[keep]
        cols = cols[keep]

    verts, faces, vcols = _weld_colored(tris, cols)
    # Samples live at voxel CENTRES: grid coord v maps to
    # origin + (v + 0.5) · voxel.
    world = (verts + np.float32(0.5)) * np.float32(voxel_size) \
        + np.asarray(origin, np.float32)
    mesh = TriangleMesh(world.astype(np.float32), faces)
    if with_colors:
        mesh.vertex_colors = np.clip(np.round(vcols), 0, 255).astype(np.uint8)
    if len(mesh.faces):
        mesh.compute_vertex_normals()
    return mesh
