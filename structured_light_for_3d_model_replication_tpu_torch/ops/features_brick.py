"""Brick-layout FPFH (counterpart of the JAX ``ops/features_brick.py``; the
``MergeParams.fpfh_engine="brick"`` preprocess).

1. quantize once into cells of edge ``radius`` (so a query's neighbour
   ball lies in its 3³ cell neighbourhood), stable-sort by packed cell id,
   pack each occupied cell into a ``slots``-wide brick (the brick KNN's
   shared steps, :mod:`.brickknn`);
2. every query row (sorted order; a slot-overflow point still queries, it
   only stops appearing as a candidate) takes its 27 neighbour bricks;
3. Darboux angles and the 3 × 11-bin histograms over those candidates
   with a radius mask — every in-radius pair, not the nearest 100 the
   "gather" engine caps at (the reference's ``KDTreeSearchParamHybrid``
   efficiency bound, `server/processing.py:92-94`);
4. the SPFH table re-read brick-wise for the distance-weighted FPFH sum,
   each sub-histogram L1-normalized to 100.

The third return value counts valid points lost to slot or cell-budget
overflow (they still get a descriptor but thin their neighbours'),
logged by :func:`emit_overflow_warning`.
"""

from __future__ import annotations

import logging
import math

import torch

from .brickknn import (
    _brick,
    _floor_cell_edge,
    _neighbor_ranks,
    _quantize_cells,
    _sorted_segments,
    _sq_norm,
)
from .features import FPFH_DIM, N_BINS, _bin

log = logging.getLogger(__name__)


def fpfh_brick(points: torch.Tensor, normals: torch.Tensor, radius: float,
               valid: torch.Tensor | None = None, slots: int = 48,
               max_cells: int = 1024, chunk_rows: int = 512):
    """(N, 33) float32 FPFH descriptors, (N,) validity and the overflow
    count (int), in brick layout. ``slots`` bounds the candidates per cell,
    ``max_cells`` the occupied cells, ``chunk_rows`` the rows per block of
    the (rows, 27·slots) intermediates."""
    n = points.shape[0]
    dev = points.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    pts = points.to(torch.float32)
    nrm = normals.to(torch.float32)
    r2 = torch.tensor(radius * radius, dtype=torch.float32, device=dev)
    S, M = slots, max_cells

    h, mins = _floor_cell_edge(pts, valid, torch.tensor(
        radius, dtype=torch.float32, device=dev))
    cid = _quantize_cells(pts, valid, h, mins)
    (cid_s, pts_s, val_s, orig_s, _, _, ok, dest,
     ucid) = _sorted_segments(pts, valid, cid, S, M)
    nrm_s = nrm[orig_s]

    def padded(t, fill):   # brick table + one absent brick at index M
        b = _brick(t, dest, M * S, fill).reshape((M, S) + t.shape[1:])
        return torch.cat([b, torch.full((1, S) + t.shape[1:], fill,
                                        dtype=t.dtype, device=dev)])

    bppad, bnpad = padded(pts_s, 0.0), padded(nrm_s, 0.0)
    bvpad, bopad = padded(ok, False), padded(orig_s, -1)
    # Per sorted ROW, not per cell: rows whose cell fell past the brick
    # budget still query their neighbourhood.
    nbr = _neighbor_ranks(cid_s, ucid, M)              # (N, 27)

    def pair_geometry(sl):
        """Candidate positions, d² and the radius/self/validity mask of the
        rows ``sl`` over their 27·S lanes."""
        q, qo, qv, nb = pts_s[sl], orig_s[sl], val_s[sl], nbr[sl]
        c = q.shape[0]
        kp = bppad[nb].reshape(c, 27 * S, 3)
        kv = bvpad[nb].reshape(c, 27 * S)
        ko = bopad[nb].reshape(c, 27 * S)
        d2 = _sq_norm(q)[:, None] + _sq_norm(kp) \
            - 2.0 * torch.bmm(kp, q[:, :, None])[..., 0]
        pair_ok = kv & (d2 <= r2) & (ko != qo[:, None]) & qv[:, None]
        return q, nb, kp, d2, pair_ok

    comp = torch.arange(3, device=dev) * N_BINS
    spfh_s = torch.empty((n, FPFH_DIM), dtype=torch.float32, device=dev)
    cnt_s = torch.empty(n, dtype=torch.int64, device=dev)
    for s in range(0, n, chunk_rows):
        sl = slice(s, min(s + chunk_rows, n))
        q, nb, kp, _, pair_ok = pair_geometry(sl)
        c = q.shape[0]
        kn = bnpad[nb].reshape(c, 27 * S, 3)
        dvec = kp - q[:, None, :]
        dist = torch.sqrt((dvec * dvec).sum(-1).clamp_min(1e-20))
        dn = dvec / dist[..., None]
        u = nrm_s[sl][:, None, :].expand_as(dvec)
        v = torch.linalg.cross(u, dn, dim=-1)
        v_norm = torch.linalg.norm(v, dim=-1, keepdim=True)
        v = v / torch.where(v_norm > 1e-12, v_norm, torch.ones((),
                                                               device=dev))
        w = torch.linalg.cross(u, v, dim=-1)
        alpha = (v * kn).sum(-1)
        phi = (u * dn).sum(-1)
        theta = torch.atan2((w * kn).sum(-1), (u * kn).sum(-1))
        bins = torch.stack([_bin(alpha, -1.0, 1.0), _bin(phi, -1.0, 1.0),
                            _bin(theta, -math.pi, math.pi)], -1) + comp
        # Histogram of the in-radius pairs (sums of ones: exact in any
        # order, like the JAX package's one-hot sum).
        hist = torch.zeros((c, FPFH_DIM), dtype=torch.float32, device=dev)
        # torchlint: disable=atomic-scatter -- sums of ones are exact
        hist.scatter_add_(1, bins.reshape(c, -1), pair_ok[..., None].expand(
            c, 27 * S, 3).reshape(c, -1).to(torch.float32))
        cnt = pair_ok.sum(1)
        spfh_s[sl] = hist / cnt.clamp_min(1)[:, None].to(torch.float32)
        cnt_s[sl] = cnt

    # SPFH brick table for the weighted aggregation.
    bspad = padded(torch.where(ok[:, None], spfh_s,
                               torch.zeros((), device=dev)), 0.0)
    f_s = torch.empty((n, FPFH_DIM), dtype=torch.float32, device=dev)
    for s in range(0, n, chunk_rows):
        sl = slice(s, min(s + chunk_rows, n))
        q, nb, _, d2, pair_ok = pair_geometry(sl)
        c = q.shape[0]
        ks = bspad[nb].reshape(c, 27 * S, FPFH_DIM)
        dist = torch.sqrt(d2.clamp_min(1e-20))
        wgt = torch.where(pair_ok, 1.0 / dist.clamp_min(1e-12),
                          torch.zeros((), device=dev))
        wsum = wgt.sum(1).clamp_min(1e-12)[:, None]
        f_s[sl] = spfh_s[sl] + torch.bmm(wgt[:, None, :], ks)[:, 0] / wsum

    f3 = f_s.reshape(n, 3, N_BINS)
    f_s = (100.0 * f3 / f3.sum(-1, keepdim=True).clamp_min(1e-12)).reshape(
        n, FPFH_DIM)
    fv_s = val_s & (cnt_s >= 1)
    f_s = torch.where(fv_s[:, None], f_s, torch.zeros((), device=dev))
    # Back to the original row order (a permutation).
    out_f = torch.empty_like(f_s).index_copy_(0, orig_s, f_s)
    out_v = torch.empty_like(fv_s).index_copy_(0, orig_s, fv_s)
    return out_f, out_v, int((val_s & ~ok).sum())


def emit_overflow_warning(n_overflow, n_total) -> None:
    """Log the candidate thinning of :func:`fpfh_brick`, when there is any."""
    no = int(n_overflow)
    if no > 0:
        log.warning(
            "fpfh_brick thinned %d/%d points out of the candidate set "
            "(cell-slot overflow or cell budget); their neighbors' "
            "descriptors are computed from fewer pairs — raise "
            "`slots`/`max_cells` (MergeParams.fpfh_slots/fpfh_max_cells) "
            "for full coverage", no, int(n_total))
