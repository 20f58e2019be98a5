"""Fused statistical-outlier-removal + normal estimation in one Morton-sorted
layout (counterpart of the JAX ``ops/sor_normals.py``).

1. sort points once by 30-bit Morton code (``ops/mortonknn.py`` scheme);
2. per block of B sorted points the candidate window is blocks b−1, b,
   b+1 — three contiguous slices, no gather;
3. phase 1 (SOR): per-point mean distance to its ``nb_neighbors`` nearest
   window points (self excluded) → global μ/σ → keep mask;
4. phase 2 (normals): the same layout with dropped outliers masked out of
   the window; membership is ``d2 ≤ k-th distance`` and the PCA moments
   reduce through the window as batched matmuls
   (cnt = W·1, s1 = W·p, s2 = W·(p⊗p) → Σ = s2/cnt − μμᵀ);
5. un-sort the outputs.

The JAX package selects with ``lax.approx_min_k`` on a TPU; the port selects
exactly (:func:`.knn.smallest_k`) inside the same window, as the JAX package
does on the CPU.
"""

from __future__ import annotations

import torch

from .knn import smallest_k
from .mortonknn import blocked, window_dists, with_neighbors
from .pointcloud import _sor_mask, smallest_eigenvector_sym3

_II = (0, 0, 0, 1, 1, 2)
_JJ = (0, 1, 2, 1, 2, 2)


def sor_normals(points: torch.Tensor, valid: torch.Tensor | None = None,
                nb_neighbors: int = 20, std_ratio: float = 2.0,
                k_normals: int = 30, block: int = 256,
                chunk_blocks: int = 64):
    """Fused SOR → normals-on-survivors. Returns ``(keep (N,) bool,
    normals (N,3), normal_valid (N,))`` — equivalent to
    ``statistical_outlier_removal`` followed by
    ``estimate_normals(valid=keep)`` on the Morton-window neighbourhood."""
    points = points.to(torch.float32)
    n = points.shape[0]
    dev = points.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    if 3 * block < max(nb_neighbors + 1, k_normals):
        raise ValueError(f"block {block} too small for nb={nb_neighbors}/"
                         f"k={k_normals}")
    bp, bv, orig = blocked(points, valid, block)
    nb = bp.shape[0]
    brow = torch.arange(nb * block, device=dev).reshape(nb, block)
    cp, cv, crow = with_neighbors(bp), with_neighbors(bv), \
        with_neighbors(brow)
    groups = range(0, nb, chunk_blocks)
    zero = torch.zeros((), device=dev)

    # --- phase 1: SOR mean neighbour distance ---------------------------
    means, has = [], []
    for g in groups:
        s = slice(g, g + chunk_blocks)
        bad = ~cv[s][:, None, :] | (brow[s][:, :, None] == crow[s][:, None, :])
        d2 = window_dists(bp[s], cp[s], bad)
        cd, _ = smallest_k(d2.reshape(-1, d2.shape[-1]), nb_neighbors)
        ok = torch.isfinite(cd)
        dd = torch.sqrt(torch.where(ok, cd, zero).clamp_min(0.0))
        cnt = ok.sum(1)
        means.append(dd.sum(1) / cnt.clamp_min(1))
        has.append(cnt > 0)
    keep_flat, _ = _sor_mask(torch.cat(means), torch.cat(has),
                             bv.reshape(-1), std_ratio)   # sorted domain

    # --- phase 2: normals among the survivors ---------------------------
    # The keep-mask windows roll over the block axis padded to a whole
    # number of chunks (padding blocks keep nothing), as the JAX package
    # builds them: an edge block's wrapped neighbour is then a padding block.
    bk = keep_flat.reshape(nb, block)
    nb_pad = (-nb) % chunk_blocks
    if nb_pad:
        bk = torch.cat([bk, bk.new_zeros((nb_pad, block))])
    ck = with_neighbors(bk)[:nb]
    ii = torch.tensor(_II, dtype=torch.int64, device=dev)
    jj = torch.tensor(_JJ, dtype=torch.int64, device=dev)
    nrms, cnts = [], []
    for g in groups:
        s = slice(g, g + chunk_blocks)
        q, kp, kk = bp[s], cp[s], ck[s]
        bad = (~kk[:, None, :]).expand(-1, block, -1)  # self iff it survived
        d2 = window_dists(q, kp, bad)
        cd, _ = smallest_k(d2.reshape(-1, d2.shape[-1]), k_normals)
        kth = torch.where(torch.isfinite(cd), cd, zero).amax(1)
        W = (d2 <= kth.reshape(q.shape[0], block)[..., None]).to(
            torch.float32) * (~bad).to(torch.float32)    # (C, B, 3B)
        wsum = W.sum(2)
        cnt = wsum.clamp_min(1.0)
        s1 = torch.bmm(W, kp)
        op = kp[..., ii] * kp[..., jj]                   # (C, 3B, 6)
        s2 = torch.bmm(W, op)
        mu = s1 / cnt[..., None]
        cov6 = s2 / cnt[..., None] - mu[..., ii] * mu[..., jj]
        C = torch.stack([
            torch.stack([cov6[..., 0], cov6[..., 1], cov6[..., 2]], -1),
            torch.stack([cov6[..., 1], cov6[..., 3], cov6[..., 4]], -1),
            torch.stack([cov6[..., 2], cov6[..., 4], cov6[..., 5]], -1),
        ], -2)
        nrms.append(smallest_eigenvector_sym3(C.reshape(-1, 3, 3)))
        cnts.append(wsum.to(torch.int32).reshape(-1))
    nrm_s = torch.cat(nrms)[:n]
    cnt_s = torch.cat(cnts)[:n]
    keep_s = keep_flat[:n]

    # --- un-sort: sorted row r < n belongs to original index orig[r] ------
    src = orig[:n]
    keep = torch.empty_like(keep_s).index_copy_(0, src, keep_s)
    normals = torch.empty_like(nrm_s).index_copy_(0, src, nrm_s)
    cnt = torch.empty_like(cnt_s).index_copy_(0, src, cnt_s)
    return keep, normals, keep & (cnt >= 3)
