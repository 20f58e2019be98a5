"""Spatial-grid KNN (counterpart of the JAX ``ops/gridknn.py``, the
``"grid"`` engine of :func:`..ops.pointcloud._self_knn`), and the cell-size
estimate the brick engine (:mod:`.brickknn`) shares.

1. cell size: the median sampled k-th-NN distance (a strided query sample
   against a strided key sample, brute force), scaled for the sample's
   sparsity;
2. one stable sort of packed 10-bit/axis cell ids groups the points;
   per-cell segments are found by binary search;
3. each query takes up to ``capacity`` candidates from each of its 27
   neighbour cells (the overflow tail of a cell is dropped, a bounded and
   documented approximation);
4. the candidates' direct-difference distances reduce to the k smallest,
   ascending, ties to the lower candidate position (the JAX ``top_k``
   order).

Same ``(sq_dists, indices, neighbor_valid)`` contract as
:func:`..ops.knn.knn`.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import div
from .knn import smallest_k

_BITS = 10           # 10 bits per axis → 1024³ addressable cells, id < 2³⁰
_GRID_MAX = (1 << _BITS) - 1
_BIG = 1 << 30

_DELTAS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
           for dz in (-1, 0, 1)]


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distance by direct difference over the last axis (size 3),
    summed x, y, z in order like the JAX package's ``jnp.sum``."""
    d = a - b
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
        + d[..., 2] * d[..., 2]


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian`` of a 1-D float32 tensor: the linear-interpolation
    median of the non-NaN values (the mean of the two middle ones for an
    even count, formed as ``lo·0.5 + hi·0.5``) — ``torch.nanmedian``
    returns the lower middle value instead. NaN when every value is."""
    s = torch.sort(x).values                    # NaN sorts last
    cnt = (~torch.isnan(s)).sum().to(torch.float32)
    q = 0.5 * (cnt - 1.0)
    lo = torch.floor(q)
    hi = torch.ceil(q)
    hw = q - lo
    lw = 1.0 - hw
    top = cnt - 1.0
    lo_i = torch.maximum(torch.zeros_like(lo), torch.minimum(lo, top))
    hi_i = torch.maximum(torch.zeros_like(hi), torch.minimum(hi, top))
    return s[lo_i.to(torch.int64)] * lw + s[hi_i.to(torch.int64)] * hw


def _estimate_cell_size(points: torch.Tensor, valid: torch.Tensor,
                        k: int) -> torch.Tensor:
    """Median sampled k-th-NN distance — the radius a cell must cover
    (0-d float32 tensor; 1.0 when it cannot be estimated)."""
    n = points.shape[0]
    dev = points.device
    s = max(1, n // 1024)
    p = max(1, n // 8192)
    qi = torch.arange(min(1024, (n + s - 1) // s), device=dev) * s
    pi = torch.arange(min(8192, (n + p - 1) // p), device=dev) * p
    q_samp, qv = points[qi], valid[qi]
    p_samp, pv = points[pi], valid[pi]
    d2 = _sq_dist(q_samp[:, None, :], p_samp[None, :, :])
    d2 = torch.where(pv[None, :], d2, torch.full((), float("inf"),
                                                 device=dev))
    kk = min(k + 1, p_samp.shape[0])  # +1: the sample may contain the query
    kth2 = torch.topk(d2, kk, dim=1, largest=False, sorted=True).values[:, -1]
    kth = torch.sqrt(kth2.clamp_min(1e-20))
    kth = torch.where(qv & torch.isfinite(kth), kth,
                      torch.full((), float("nan"), device=dev))
    med = _nanmedian(kth)
    # The key sample is p× sparser than the cloud: scale by the surface
    # exponent, p^(-1/2) (the conservative one), rounded as the JAX
    # package's constant-folded float32 power is, on every device.
    scale = np.float32(p) ** np.float32(-0.5)
    med = med * torch.tensor(float(scale), dtype=torch.float32, device=dev)
    return torch.where(torch.isfinite(med) & (med > 0), med,
                       torch.ones((), device=dev))


def grid_knn(points: torch.Tensor, k: int,
             points_valid: torch.Tensor | None = None,
             exclude_self: bool = False, capacity: int = 16,
             q_tile: int = 8192):
    """Self-query KNN over a spatial grid. Returns (sq_dists (N, k),
    indices (N, k) int64, neighbor_valid (N, k)), ascending."""
    points = points.to(torch.float32)
    n = points.shape[0]
    dev = points.device
    if points_valid is None:
        points_valid = torch.ones(n, dtype=torch.bool, device=dev)
    if 27 * capacity < k:
        raise ValueError(f"capacity {capacity} too small for k={k}")
    q_tile = min(q_tile, max(256, n))
    valid = points_valid
    h = _estimate_cell_size(points, valid, k)

    # Clamped 10-bit cell coordinates: a cloud wider than 1024 cells on an
    # axis coarsens the grid instead of wrapping.
    inf = torch.full((), float("inf"), device=dev)
    mins = torch.where(valid[:, None], points, inf).amin(0)
    maxs = torch.where(valid[:, None], points, -inf).amax(0)
    extent = (maxs - mins).max()
    h = torch.maximum(h, div(extent, float(_GRID_MAX - 2)) + 1e-12)
    cell = ((points - mins) / h).to(torch.int32).clamp(0, _GRID_MAX)
    cid = (cell[:, 0] << (2 * _BITS)) | (cell[:, 1] << _BITS) | cell[:, 2]
    cid = torch.where(valid, cid, torch.full((), _BIG, dtype=torch.int32,
                                             device=dev))
    order = torch.argsort(cid, stable=True)
    cid_sorted = cid[order].contiguous()
    pts_sorted = points[order]

    # Arithmetic neighbour offsets; offsets whose per-axis coordinate leaves
    # the grid are masked (the packed sum would alias a far-away cell).
    offsets = torch.tensor([dx * (1 << (2 * _BITS)) + dy * (1 << _BITS) + dz
                            for dx, dy, dz in _DELTAS], dtype=torch.int32,
                           device=dev)
    delta_xyz = torch.tensor(_DELTAS, dtype=torch.int32, device=dev)
    slot_ar = torch.arange(capacity, device=dev)

    pad = (-n) % q_tile
    qp = torch.cat([points, points.new_zeros((pad, 3))]) if pad else points
    cp = torch.cat([cid, torch.full((pad,), _BIG, dtype=torch.int32,
                                    device=dev)]) if pad else cid
    vp = torch.cat([valid, valid.new_zeros(pad)]) if pad else valid
    ds, is_, vs = [], [], []
    for s in range(0, qp.shape[0], q_tile):
        q, q_cid, qv = qp[s:s + q_tile], cp[s:s + q_tile], vp[s:s + q_tile]
        q_idx = torch.arange(s, s + q.shape[0], device=dev)
        cand_cid = q_cid[:, None] + offsets[None, :]             # (T, 27)
        q_xyz = torch.stack([q_cid >> (2 * _BITS),
                             (q_cid >> _BITS) & _GRID_MAX,
                             q_cid & _GRID_MAX], dim=-1)
        nb_xyz = q_xyz[:, None, :] + delta_xyz[None]
        in_grid = ((nb_xyz >= 0) & (nb_xyz <= _GRID_MAX)).all(-1)
        start = torch.searchsorted(cid_sorted, cand_cid.reshape(-1)
                                   .contiguous()).reshape(cand_cid.shape)
        slots = start[:, :, None] + slot_ar                   # (T, 27, C)
        slots_c = slots.clamp_max(n - 1)
        ok = (slots < n) & in_grid[:, :, None] \
            & (cid_sorted[slots_c] == cand_cid[:, :, None])
        orig = order[slots_c]
        d2 = _sq_dist(q[:, None, None, :], pts_sorted[slots_c])
        if exclude_self:
            ok = ok & (orig != q_idx[:, None, None])
        d2 = torch.where(ok, d2, inf)
        cd, carg = smallest_k(d2.reshape(q.shape[0], -1), k)
        idx = torch.gather(orig.reshape(q.shape[0], -1), 1, carg)
        finite = torch.isfinite(cd)
        ds.append(torch.where(finite, cd, torch.zeros((), device=dev)))
        is_.append(idx)
        vs.append(finite & qv[:, None])
    return torch.cat(ds)[:n], torch.cat(is_)[:n], torch.cat(vs)[:n]
