"""Device-side sparse iso-surface extraction, vectorized marching tets
(counterpart of the JAX ``ops/marching_jax.py``).

The same algorithm as the host oracle (:func:`.marching.extract_sparse`):
6-tet decomposition and identical per-case edge logic, kept on the device
from classification to the welded mesh, so the only data that reaches the
host is the welded result — unique vertices and faces, plus three count
reads. Readback is tallied per call in :data:`LAST_READBACK`.

1. **corners + classification**: the 8-neighbour table of each brick
   from the face-neighbour table (diagonal neighbours by chaining face
   hops), then :func:`.marching_classify.classify_bricks` — on the card one
   launch of the CUDA kernel ``csrc/classify.cu`` — builds the (M, 729)
   corner frame of each brick (absent neighbours clamp to the own-brick
   face like the host's ``nb_vals``), marks the cells whose 8 corners
   straddle the iso level and counts them.
2. **cell compaction** into ``K`` slots (prefix sum).
3. **triangle emission** into ``T`` slots: interpolate each triangle's three
   edge crossings and orient it from inside (χ > iso) to outside with a
   per-(tet, case) flip table.
4. **tail**: the all-or-nothing winding flip (sign vote against the soup
   centroid), the optional density-quantile trim and the vertex weld on the
   float32 bit patterns — shared crossings are bit-identical because every
   edge is interpolated from its lower cube corner.

Capacities are bucketed to powers of two (:func:`_bucket`) and sliced to
the true counts on the device before the readback. A scatter that the JAX
package drops past the end (``mode="drop"``) writes into one spare row here,
which is cut off.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.stl import TriangleMesh
from .marching import _CORNERS, _TETS
# The frame tables live with the classify pass; ``fusion/extract.py`` reads
# them (and ``_t``) from here.
from .marching_classify import (  # noqa: F401
    _CASE9,
    _CIDX,
    _CLAMP9,
    _SRC9,
    _V,
    BS,
    _t,
    classify_bricks,
    corner_frame_reference,
)

# Cell → its own (x, y, z) voxel coords, for world positioning.
_CELL_XYZ = np.stack([np.arange(_V) // (BS * BS), (np.arange(_V) // BS) % BS,
                      np.arange(_V) % BS], axis=1).astype(np.int64)


def _tet_tables():
    """The host's per-case logic (``marching._tet_triangles``) as tables:
    for each 4-bit inside mask, up to two triangles, each vertex an ordered
    (src, dst) tet-corner pair."""
    ntri = np.zeros(16, np.int64)
    ep = np.zeros((16, 2, 3, 2), np.int64)
    for case in range(16):
        ins = [(case >> i) & 1 for i in range(4)]
        k = sum(ins)
        tris = []
        if k in (1, 3):
            want = 1 if k == 1 else 0
            lone = next(i for i in range(4) if ins[i] == want)
            others = [b for b in range(4) if b != lone]
            tris.append([(lone, others[0]), (lone, others[1]),
                         (lone, others[2])])
        elif k == 2:
            a, b = [i for i in range(4) if ins[i]]
            c, d = [i for i in range(4) if not ins[i]]
            tris.append([(a, c), (a, d), (b, d)])
            tris.append([(a, c), (b, d), (b, c)])
        ntri[case] = len(tris)
        for j, t in enumerate(tris):
            ep[case, j] = t
    return ntri, ep


_NTRI, _EP = _tet_tables()

# Per-(tet, case, slot) edges in CUBE-corner ids plus the winding flip that
# makes every triangle's normal point from inside (χ > iso) to outside.
_EP_CUBE = np.zeros((6, 16, 2, 3, 2), np.int64)
_FLIP = np.zeros((6, 16, 2), bool)
for _tet in range(6):
    _P4 = _CORNERS[_TETS[_tet]].astype(np.float64)
    for _case in range(16):
        _ins = np.array([(_case >> _i) & 1 for _i in range(4)], bool)
        if not (0 < _ins.sum() < 4):
            continue
        _V4 = np.where(_ins, 1.0, 0.0)
        _in_cen = _P4[_ins].mean(axis=0)
        _out_cen = _P4[~_ins].mean(axis=0)
        for _j in range(_NTRI[_case]):
            _verts = []
            for _a, _b in _EP[_case, _j]:
                _tt = (0.5 - _V4[_a]) / (_V4[_b] - _V4[_a])
                _verts.append(_P4[_a] + _tt * (_P4[_b] - _P4[_a]))
            _n = np.cross(_verts[1] - _verts[0], _verts[2] - _verts[0])
            _FLIP[_tet, _case, _j] = float(
                np.dot(_n, _out_cen - _in_cen)) < 0.0
            for _v in range(3):
                _EP_CUBE[_tet, _case, _j, _v] = \
                    _TETS[_tet][_EP[_case, _j, _v]]
# Every edge from its lower cube corner: the crossing is then computed the
# same way from every tet that shares the edge, so shared vertices are
# bit-identical and the weld is exact. Winding order is untouched.
_EP_CUBE = np.where((_EP_CUBE[..., 0] > _EP_CUBE[..., 1])[..., None],
                    _EP_CUBE[..., ::-1], _EP_CUBE)


def _bucket(n: int, floor: int = 4096) -> int:
    """Capacity bucket: next power of two ≥ max(n, floor)."""
    return max(floor, 1 << (max(n, 1) - 1).bit_length())


#: Per-call device→host transfer tally: cleared at the top of
#: :func:`extract_sparse_device`, one entry per named readback with its
#: byte count — exactly {"counts", "vertices", "faces"}.
LAST_READBACK: dict[str, int] = {}


def _pull(name: str, t: torch.Tensor) -> np.ndarray:
    """Copy ``t`` to the host and tally the bytes under ``name``."""
    out = t.cpu().numpy()
    LAST_READBACK[name] = LAST_READBACK.get(name, 0) + out.nbytes
    return out


def _compact(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """Positions of the True entries of a flat mask, ascending, in ``cap``
    slots (-1 past the count)."""
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    dest = torch.where(mask, rank.clamp_max(cap), cap)
    out = torch.full((cap + 1,), -1, dtype=torch.int64, device=mask.device)
    out.scatter_(0, dest, torch.arange(mask.shape[0], device=mask.device))
    return out[:cap]


def _nb8_table(nbr: torch.Tensor) -> torch.Tensor:
    """(M, 6) face-neighbour slots → (M, 8) [own, +x, +y, +z, +xy, +xz, +yz,
    +xyz]. Diagonals chain two or three face hops and take the minimum over
    the hop orders (absent = M sorts last, so any reachable path wins)."""
    m = nbr.shape[0]
    nb = nbr.to(torch.int64).clamp(0, m)
    nbp = torch.cat([nb, torch.full((1, 6), m, dtype=torch.int64,
                                    device=nb.device)])
    own = torch.arange(m, device=nb.device)
    px, py, pz = nb[:, 0], nb[:, 2], nb[:, 4]
    pxy = torch.minimum(nbp[px, 2], nbp[py, 0])
    pxz = torch.minimum(nbp[px, 4], nbp[pz, 0])
    pyz = torch.minimum(nbp[py, 4], nbp[pz, 2])
    pxyz = torch.minimum(torch.minimum(nbp[pxy, 4], nbp[pxz, 2]),
                         nbp[pyz, 0])
    return torch.stack([own, px, py, pz, pxy, pxz, pyz, pxyz], 1)


def corner_frame(chi: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """(M, 512) bricks + (M, 6) neighbour slots → (M, 729) corner frame,
    the plain version (the extractor's own pass builds it in
    :func:`.marching_classify.classify_bricks`)."""
    return corner_frame_reference(chi, _nb8_table(nbr))


def _phase_corners(chi, nbr, block_valid, iso):
    """Corner frame (M, 729), active-cell mask (M, 512) and its count, in
    one launch on the card."""
    return classify_bricks(chi, _nb8_table(nbr), iso, block_valid)


def _phase_count(c9, cell_ids, iso):
    """Compacted cell ids → (triangle count, (bk, ck, v8, case))."""
    dev = c9.device
    ok = cell_ids >= 0
    bk = torch.where(ok, cell_ids // _V, 0)
    ck = torch.where(ok, cell_ids % _V, 0)
    v8 = c9[bk[:, None], _t(_CIDX, dev)[ck]]                    # (K, 8)
    vt = v8[:, _t(_TETS, dev)]                                  # (K, 6, 4)
    inside = (vt > iso) & ok[:, None, None]
    bits = torch.tensor([1, 2, 4, 8], dtype=torch.int64, device=dev)
    case = (inside.to(torch.int64) * bits).sum(-1)              # (K, 6)
    return _t(_NTRI, dev)[case].sum(dtype=torch.int32), (bk, ck, v8, case)


def _phase_triangles(cells, density, block_coords, iso, T: int):
    """Compact the triangle slots and emit the oriented soup: (tris
    (T, 3, 3) float32 grid coords, density (T,)); slots past the true count
    hold garbage."""
    bk, ck, v8, case = cells
    dev = v8.device
    nt = _t(_NTRI, dev)[case]                                   # (K, 6)
    tv = (torch.arange(2, device=dev)[None, None, :]
          < nt[:, :, None]).reshape(-1)                         # (K·12,)
    src = _compact(tv, T).clamp_min(0)
    k = src // 12
    t = (src % 12) // 2
    j = src % 2
    case_t = case[k, t]                                         # (T,)
    epc = _t(_EP_CUBE, dev)[t, case_t, j]                       # (T, 3, 2)
    v8k = v8[k]                                                 # (T, 8)
    va = torch.gather(v8k, 1, epc[:, :, 0])                     # (T, 3)
    vb = torch.gather(v8k, 1, epc[:, :, 1])
    base = (block_coords[bk[k]].to(torch.int64) * BS
            + _t(_CELL_XYZ, dev)[ck[k]])                        # (T, 3)
    corners = _t(_CORNERS, dev)
    pa = (base[:, None, :] + corners[epc[:, :, 0]]).to(torch.float32)
    pb = (base[:, None, :] + corners[epc[:, :, 1]]).to(torch.float32)
    denom = vb - va
    safe = denom.abs() > 1e-12
    tt = torch.where(safe, (iso - va) / torch.where(
        safe, denom, torch.ones((), device=dev)),
        torch.full((), 0.5, device=dev)).clamp(0.0, 1.0)
    tris = pa + tt[..., None] * (pb - pa)                       # (T, 3, 3)
    flip = _t(_FLIP, dev)[t, case_t, j]
    tris = torch.where(flip[:, None, None], tris.flip(1), tris)
    return tris, density[bk[k], ck[k]]


def _lexsort(keys) -> torch.Tensor:
    """``np.lexsort`` order (the LAST key is primary): stable sorts chained
    from the least significant key to the most significant."""
    order = torch.argsort(keys[0], stable=True)
    for key in keys[1:]:
        order = order[torch.argsort(key[order], stable=True)]
    return order


def _phase_tail(tris, dens, n: int, trim: float, do_trim: bool):
    """Winding vote + optional quantile trim + vertex weld. ``tris`` is the
    (T, 3, 3) soup with ``n`` real rows. Returns (uverts (3T, 3) float32,
    faces (T, 3) int32, counts (2,) int32 = [nv, nf])."""
    T = tris.shape[0]
    dev = tris.device
    zero = torch.zeros((), device=dev)
    valid = torch.arange(T, device=dev) < n

    # Global outward decision: the soup is already field-consistent, so one
    # sign vote against the soup centroid flips every triangle or none.
    cen = tris.mean(1)
    vf = valid.to(torch.float32)
    gcen = (cen * vf[:, None]).sum(0) / vf.sum().clamp_min(1.0)
    nrm = torch.linalg.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    vote = (nrm * (cen - gcen)).sum(-1)
    outward_flip = torch.where(valid, torch.sign(vote), zero).sum() <= 0.0
    tris = torch.where(outward_flip, tris.flip(1), tris)

    keep = valid
    if do_trim:
        sd = torch.sort(torch.where(valid, dens, torch.full(
            (), float("inf"), device=dev))).values
        pos = torch.tensor(trim, dtype=torch.float32) * float(n - 1)
        lo = min(max(int(torch.floor(pos)), 0), n - 1)
        hi = min(lo + 1, n - 1)
        frac = (pos - lo).to(dev)
        thresh = sd[lo] * (1.0 - frac) + sd[hi] * frac
        keep = keep & (dens > thresh)

    # Weld: float bits → lexsort (dropped rows last) → first-occurrence
    # group ids → unique vertices and inverse-mapped faces.
    vflat = tris.reshape(T * 3, 3) + 0.0             # −0.0 → +0.0
    vkeep = keep.repeat_interleave(3)
    key = vflat.contiguous().view(torch.int32)
    order = _lexsort((key[:, 2], key[:, 1], key[:, 0],
                      (~vkeep).to(torch.int32)))
    ks = key[order]
    valid_s = vkeep[order]
    newg = torch.ones_like(valid_s)
    newg[1:] = (ks[1:] != ks[:-1]).any(1)
    newg = newg & valid_s
    gid = torch.cumsum(newg.to(torch.int64), 0) - 1
    nv = newg.sum(dtype=torch.int32)
    big = T * 3
    uverts = torch.zeros((big + 1, 3), dtype=torch.float32, device=dev)
    uverts[torch.where(newg, gid, big)] = vflat[order]
    inv = torch.empty((big,), dtype=torch.int64, device=dev)
    inv[order] = torch.where(valid_s, gid, 0)
    faces = inv.reshape(T, 3)
    good = (keep & (faces[:, 0] != faces[:, 1])
            & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2]))
    rank = torch.cumsum(good.to(torch.int64), 0) - 1
    dest = torch.where(good, rank.clamp_max(T), T)
    faces_c = torch.zeros((T + 1, 3), dtype=torch.int32, device=dev)
    faces_c[dest] = faces.to(torch.int32)
    nf = good.sum(dtype=torch.int32)
    return uverts[:big], faces_c[:T], torch.stack([nv, nf])


def _empty_mesh() -> TriangleMesh:
    return TriangleMesh(np.zeros((0, 3), np.float32),
                        np.zeros((0, 3), np.int32))


def extract_sparse_device(grid, quantile_trim: float = 0.0) -> TriangleMesh:
    """SparsePoissonGrid → welded TriangleMesh, extraction on the grid's
    device (the card on the main path; the plain versions on a CPU grid).
    Needs the grid's ``nbr`` table (grids from ``reconstruct_sparse`` carry
    it)."""
    if grid.nbr is None:
        raise ValueError("extract_sparse_device needs grid.nbr (grids built "
                         "by reconstruct_sparse carry it); use the host "
                         "extractor for hand-assembled grids")
    LAST_READBACK.clear()
    iso = grid.iso.to(torch.float32).reshape(())
    c9, active, count = _phase_corners(grid.chi, grid.nbr, grid.block_valid,
                                       iso)
    n_cells = int(_pull("counts", count))
    if n_cells == 0:
        return _empty_mesh()
    K = _bucket(n_cells)
    cell_ids = _compact(active.reshape(-1), K)
    del active
    count_d, cells = _phase_count(c9, cell_ids, iso)
    del c9
    nt = int(_pull("counts", count_d))
    if nt == 0:
        return _empty_mesh()
    tris, dens = _phase_triangles(cells, grid.density, grid.block_coords,
                                  iso, _bucket(nt))
    del cells
    uverts, faces, counts = _phase_tail(tris, dens, nt, quantile_trim,
                                        quantile_trim > 0.0)
    nv, nf = (int(c) for c in _pull("counts", counts))
    verts = _pull("vertices", uverts[:nv])
    faces = _pull("faces", faces[:nf])
    world = verts * float(grid.scale) + grid.origin.cpu().numpy().astype(
        np.float32)
    mesh = TriangleMesh(world.astype(np.float32), faces)
    if len(mesh.faces):
        mesh.compute_vertex_normals()
    return mesh
