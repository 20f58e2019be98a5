"""Morton-blocked self-query KNN (counterpart of the JAX
``ops/mortonknn.py``): sort points once by 30-bit Morton code, cut the
sorted cloud into blocks of B points, and search each block's queries over
blocks b−1, b, b+1 — three contiguous slices, no random gather.

Approximate by construction (a true neighbour further than one block away
along the curve is missed). The JAX package selects with
``lax.approx_min_k`` on a TPU; the port selects exactly within the same
candidate window (:func:`.knn.smallest_k`, ties to the lower position), as
the JAX package does on the CPU.
"""

from __future__ import annotations

import torch

from .._device import div
from .knn import smallest_k

_BITS = 10
_GRID_MAX = (1 << _BITS) - 1
_INVALID_CODE = 2**31 - 1


def _spread_bits(v: torch.Tensor) -> torch.Tensor:
    """10-bit int → bits spread to every 3rd position (Morton interleave)."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_code(cell: torch.Tensor) -> torch.Tensor:
    """(N, 3) int32 grid coords in [0, 1023] → (N,) 30-bit Morton code."""
    return (_spread_bits(cell[:, 0])
            | (_spread_bits(cell[:, 1]) << 1)
            | (_spread_bits(cell[:, 2]) << 2))


def morton_order(points: torch.Tensor, valid: torch.Tensor):
    """Stable argsort of the Morton codes of the valid points' bounding
    grid (invalid points last) — the shared first step of this module and
    ``ops/sor_normals.py``."""
    inf = torch.full((), float("inf"), device=points.device)
    mins = torch.where(valid[:, None], points, inf).amin(0)
    maxs = torch.where(valid[:, None], points, -inf).amax(0)
    h = div((maxs - mins).amax(), float(_GRID_MAX)).clamp_min(1e-12)
    cell = ((points - mins) / h).to(torch.int32).clamp(0, _GRID_MAX)
    code = morton_code(cell)
    sort_key = torch.where(valid, code, torch.full((), _INVALID_CODE,
                                                   dtype=torch.int32,
                                                   device=points.device))
    return torch.argsort(sort_key, stable=True)


def blocked(points: torch.Tensor, valid: torch.Tensor, block: int):
    """Morton-sorted, block-padded layout: (bp (nb, B, 3), bv (nb, B),
    orig (nb·B,) original index of each sorted row; padding rows → 0)."""
    n = points.shape[0]
    order = morton_order(points, valid)
    pts_s, val_s, orig_s = points[order], valid[order], order
    pad = (-n) % block
    if pad:
        pts_s = torch.cat([pts_s, pts_s.new_zeros((pad, 3))])
        val_s = torch.cat([val_s, val_s.new_zeros(pad)])
        orig_s = torch.cat([orig_s, orig_s.new_zeros(pad)])
    nb = pts_s.shape[0] // block
    return pts_s.reshape(nb, block, 3), val_s.reshape(nb, block), orig_s


def with_neighbors(x: torch.Tensor) -> torch.Tensor:
    """Candidates of block b = blocks b−1, b, b+1 (rolled: the two edge
    blocks see a wrapped far-away block, eliminated by distance)."""
    return torch.cat([torch.roll(x, 1, 0), x, torch.roll(x, -1, 0)], dim=1)


def window_dists(q: torch.Tensor, kp: torch.Tensor,
                 bad: torch.Tensor) -> torch.Tensor:
    """(C, B, 3B) squared distances by the matmul expansion, +inf where
    ``bad``."""
    q2 = torch.sum(q * q, dim=-1)
    p2 = torch.sum(kp * kp, dim=-1)
    cross = torch.bmm(q, kp.transpose(1, 2))
    d2 = q2[..., :, None] + p2[..., None, :] - 2.0 * cross
    return torch.where(bad, torch.full((), float("inf"), device=q.device), d2)


def morton_knn(points: torch.Tensor, k: int,
               points_valid: torch.Tensor | None = None,
               exclude_self: bool = False, block: int = 256,
               chunk_blocks: int = 64):
    """Self-query KNN over the Morton curve. Same contract as ``knn``:
    (sq_dists (N, k), indices (N, k) int64, neighbor_valid (N, k)),
    distances ascending."""
    points = points.to(torch.float32)
    n = points.shape[0]
    dev = points.device
    if points_valid is None:
        points_valid = torch.ones(n, dtype=torch.bool, device=dev)
    if 3 * block < k + (1 if exclude_self else 0):
        raise ValueError(f"block {block} too small for k={k}")
    bp, bv, orig = blocked(points, points_valid, block)
    nb = bp.shape[0]
    bi = orig.reshape(nb, block)
    cp, cv, ci = with_neighbors(bp), with_neighbors(bv), with_neighbors(bi)

    ds, is_, vs = [], [], []
    for g in range(0, nb, chunk_blocks):
        q, qv, qi = bp[g:g + chunk_blocks], bv[g:g + chunk_blocks], \
            bi[g:g + chunk_blocks]
        kp, kv, ki = cp[g:g + chunk_blocks], cv[g:g + chunk_blocks], \
            ci[g:g + chunk_blocks]
        bad = ~kv[:, None, :]
        if exclude_self:
            bad = bad | (qi[:, :, None] == ki[:, None, :])
        d2 = window_dists(q, kp, bad)
        flat = d2.reshape(-1, d2.shape[-1])
        cd, carg = smallest_k(flat, k)
        cand = ki[:, None, :].expand(-1, block, -1).reshape(flat.shape[0], -1)
        idx = torch.gather(cand, 1, carg)
        dd = cd.clamp_min(0.0)
        finite = torch.isfinite(dd)
        ds.append(torch.where(finite, dd, torch.zeros((), device=dev)))
        is_.append(idx)
        vs.append(finite & qv.reshape(-1)[:, None])
    # Un-sort: sorted row r < n belongs to original index orig[r]; the
    # block-padding rows beyond n are dropped.
    return tuple(torch.empty_like(x[:n]).index_copy_(0, orig[:n], x[:n])
                 for x in (torch.cat(ds), torch.cat(is_), torch.cat(vs)))
