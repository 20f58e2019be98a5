"""Brick-grid KNN — the high-recall large-N engine (counterpart of the JAX
``ops/brickknn.py``; the ``"rescue"`` method of
:func:`..ops.pointcloud._self_knn`).

1. estimate a cell size from a sampled k-th-NN distance (the grid
   engine's estimator, scaled up so a query's true neighbour ball fits its
   3³ cell neighbourhood);
2. sort by packed cell id once (stably: the lowest original indices of an
   overfull cell keep its slots) and brick every occupied cell into S
   static slots; cells with more than S points drop the overflow;
3. each cell's candidates are its 27 neighbour bricks;
4. distances from one (S × 27S) matmul expansion per cell, the k smallest
   kept, ties to the lower candidate position.

Two implementations share this set-up, as in the JAX package: the dense
form below (:func:`_brick_knn_impl`, the exact oracle and the engine for
CPU tensors) and the kernel path (:mod:`.brickknn_kernel`, the hand-written
CUDA kernel ``csrc/brick_knn.cu``), which :func:`brick_knn` takes for a
CUDA tensor when ``slots == 32``, ``k ≤ 32`` and ``n ≤ 2²⁴``.

Same ``(sq_dists, indices, neighbor_valid)`` contract as
:func:`..ops.knn.knn`; indices int64.
"""

from __future__ import annotations

import logging

import torch

from .._device import div
from .gridknn import _BIG, _BITS, _DELTAS, _GRID_MAX, _estimate_cell_size
from .knn import smallest_k

log = logging.getLogger(__name__)

S_KERNEL = 32      # the kernel path's fixed brick capacity
_CELL_CHUNK = 256  # cells per distance block of the dense form


def _floor_cell_edge(points, valid, h):
    """Clamp a requested cell edge so the grid fits 10 bits/axis for this
    cloud's extent (larger cells are always correct for 27-neighbourhood
    coverage — just more candidates per query). Returns (h, mins)."""
    inf = torch.full((), float("inf"), device=points.device)
    mins = torch.where(valid[:, None], points, inf).amin(0)
    maxs = torch.where(valid[:, None], points, -inf).amax(0)
    extent = (maxs - mins).max()
    return torch.maximum(h, div(extent, float(_GRID_MAX - 2)) + 1e-12), mins


def _quantize_cells(points, valid, h, mins):
    """Packed 10-bit/axis cell id per point, int32 (invalid → 2³⁰). The one
    quantize step of the dense form, the kernel path and the brick FPFH.
    ``h`` is a 0-d tensor, so the quotient is a true division on CUDA."""
    cell = ((points - mins) / h).to(torch.int32).clamp(0, _GRID_MAX)
    cc = (cell[:, 0] << (2 * _BITS)) | (cell[:, 1] << _BITS) | cell[:, 2]
    return torch.where(valid, cc, torch.full((), _BIG, dtype=torch.int32,
                                             device=points.device))


def _grid_cells(points, valid, k, cell_scale_x100):
    """Shared cell assignment: the r_k cell-size estimate (floored so the
    grid fits 10 bits/axis) and the quantizer of the packed cell id."""
    h = _estimate_cell_size(points, valid, k) * (cell_scale_x100 / 100.0)
    h, mins = _floor_cell_edge(points, valid, h)
    return h, lambda hh: _quantize_cells(points, valid, hh, mins)


def _sorted_segments(points, valid, cid, slots, max_cells):
    """Shared stable sort + segment structure + brick destinations (module
    docstring step 2). Returns the sorted views and each sorted point's
    brick destination (dump row ``max_cells·slots`` for overflow and budget
    drops): (cid_s, pts_s, val_s, orig_s, first, cell_rank, ok, dest,
    ucid) with ``ucid`` (max_cells,) the ascending occupied cell ids,
    2³⁰ past the occupied count."""
    n = points.shape[0]
    dev = points.device
    order = torch.argsort(cid, stable=True)
    cid_s = cid[order]
    pts_s = points[order]
    val_s = valid[order] & (cid_s < _BIG)
    orig_s = order
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       cid_s[1:] != cid_s[:-1]]) & val_s
    cell_rank = torch.cumsum(first.to(torch.int64), 0) - 1
    ar = torch.arange(n, device=dev)
    seg_start = torch.cummax(torch.where(first, ar, 0), 0).values
    within = ar - seg_start
    ok = val_s & (within < slots) & (cell_rank < max_cells)
    dest = torch.where(ok, cell_rank * slots + within,
                       torch.full((), max_cells * slots, device=dev))
    ucid = torch.full((max_cells + 1,), _BIG, dtype=torch.int32, device=dev)
    ucid[torch.where(first & (cell_rank < max_cells), cell_rank,
                     max_cells)] = torch.where(
        first, cid_s, torch.full((), _BIG, dtype=torch.int32, device=dev))
    return (cid_s, pts_s, val_s, orig_s, first, cell_rank, ok, dest,
            ucid[:-1].contiguous())


def _brick(vals, dest, rows: int, fill):
    """Scatter sorted per-point values into ``rows`` brick slots (+1 dump
    row, cut off): the spare-row form of the JAX package's dropping
    ``.at[dest].set``."""
    out = torch.full((rows + 1,) + tuple(vals.shape[1:]), fill,
                     dtype=vals.dtype, device=vals.device)
    out[dest] = vals
    return out[:-1]


def _neighbor_ranks(cids, ucid, m_cells: int):
    """(Q, 27) rank in the ascending occupied-id table ``ucid`` of the 27
    neighbour cells of each packed cell id in ``cids``, ``m_cells`` where
    absent (boundary-masked per axis: packed-id arithmetic aliases across
    an axis borrow otherwise)."""
    dev = ucid.device
    ux = cids >> (2 * _BITS)
    uy = (cids >> _BITS) & _GRID_MAX
    uz = cids & _GRID_MAX
    deltas = torch.tensor(_DELTAS, dtype=torch.int32, device=dev)
    nxyz = torch.stack([ux, uy, uz], -1)[:, None, :] + deltas[None]
    in_grid = ((nxyz >= 0) & (nxyz <= _GRID_MAX)).all(-1) \
        & (cids < _BIG)[:, None]
    ncid = (nxyz[..., 0] << (2 * _BITS)) | (nxyz[..., 1] << _BITS) \
        | nxyz[..., 2]
    big = torch.full((), _BIG, dtype=torch.int32, device=dev)
    pos = torch.searchsorted(ucid, torch.where(in_grid, ncid, big)
                             .reshape(-1)).reshape(ncid.shape)
    pos_c = pos.clamp_max(m_cells - 1)
    return torch.where(in_grid & (ucid[pos_c] == ncid), pos_c,
                       torch.full((), m_cells, device=dev))


def _sq_norm(x: torch.Tensor) -> torch.Tensor:
    """Σ x² over the last axis (size 3) rounded as the JAX package's fused
    ``jnp.sum(x * x, -1)`` is on the CPU: a fused multiply-add chain,
    fma(z, z, fma(y, y, x·x)), emulated in float64 (each product exact)."""
    x64 = x.to(torch.float64)
    t = (x64[..., 0] * x64[..., 0]).to(torch.float32)
    t = (t.to(torch.float64) + x64[..., 1] * x64[..., 1]).to(torch.float32)
    return (t.to(torch.float64) + x64[..., 2] * x64[..., 2]).to(
        torch.float32)


def _brick_knn_impl(points, valid, k: int, slots: int, exclude_self: bool,
                    cell_scale_x100: int, max_cells: int):
    """The dense form: every occupied cell's S queries against its 27
    neighbour bricks by the matmul expansion, in blocks of cells. Returns
    (d (N, k), idx (N, k) int64, nb_valid (N, k), n_dropped)."""
    n = points.shape[0]
    dev = points.device
    S, M = slots, max_cells
    h, quantize = _grid_cells(points, valid, k, cell_scale_x100)
    cid = quantize(h)
    (_, pts_s, val_s, orig_s, first, _, ok, dest,
     ucid) = _sorted_segments(points, valid, cid, S, M)
    bp = _brick(pts_s, dest, M * S, 0.0).reshape(M, S, 3)
    bo = _brick(orig_s, dest, M * S, -1).reshape(M, S)
    bv = _brick(ok, dest, M * S, False).reshape(M, S)
    nbr = _neighbor_ranks(ucid, ucid, M)
    bppad = torch.cat([bp, bp.new_zeros((1, S, 3))])
    bopad = torch.cat([bo, bo.new_full((1, S), -1)])
    bvpad = torch.cat([bv, bv.new_zeros((1, S))])

    # Cells past the occupied count hold no point: none of their rows is
    # scattered back, so only the occupied prefix is computed.
    m_occ = min(int(first.sum()), M)
    inf = torch.full((), float("inf"), device=dev)
    ds, is_, vs = [], [], []
    for c0 in range(0, m_occ, _CELL_CHUNK):
        sl = slice(c0, min(c0 + _CELL_CHUNK, m_occ))
        q, qv, qo, nb = bp[sl], bv[sl], bo[sl], nbr[sl]
        c = q.shape[0]
        kp = bppad[nb].reshape(c, 27 * S, 3)
        kv = bvpad[nb].reshape(c, 27 * S)
        ko = bopad[nb].reshape(c, 27 * S)
        cross = torch.bmm(q, kp.transpose(1, 2))
        d2 = _sq_norm(q)[..., :, None] + _sq_norm(kp)[..., None, :] \
            - 2.0 * cross
        bad = ~kv[:, None, :]
        if exclude_self:
            bad = bad | (qo[:, :, None] == ko[:, None, :])
        d2 = torch.where(bad, inf, d2).reshape(c * S, 27 * S)
        cd, carg = smallest_k(d2, k)
        cand = ko[:, None, :].expand(c, S, 27 * S).reshape(c * S, 27 * S)
        idx = torch.gather(cand, 1, carg)
        dd = cd.clamp_min(0.0)
        finite = torch.isfinite(dd)
        ds.append(torch.where(finite, dd, torch.zeros((), device=dev)))
        is_.append(idx)
        vs.append(finite & qv.reshape(-1)[:, None])
    # Scatter back to original rows (dropped points keep the zero rows).
    out_d = torch.zeros((n + 1, k), dtype=torch.float32, device=dev)
    out_i = torch.zeros((n + 1, k), dtype=torch.int64, device=dev)
    out_v = torch.zeros((n + 1, k), dtype=torch.bool, device=dev)
    if m_occ:
        qo_flat = bo[:m_occ].reshape(-1)
        rows = torch.where(qo_flat >= 0, qo_flat,
                           torch.full((), n, device=dev))
        out_d[rows] = torch.cat(ds)
        out_i[rows] = torch.cat(is_)
        out_v[rows] = torch.cat(vs)
    n_dropped = (val_s & ~ok).sum()
    return out_d[:n], out_i[:n], out_v[:n], n_dropped


def _rescue_dropped(points, points_valid, d, i, v, *, exclude_self: bool,
                    max_rescue: int):
    """Exact second pass for slot/budget-dropped rows (all-False ``v``):
    up to ``max_rescue`` dropped valid rows, in index order, are solved by
    brute force against the whole cloud (matmul expansion, 65,536-key
    chunks, the k (+1) smallest per chunk merged, ties to the lower index)
    and written back. Returns (d, i, v, remaining drops)."""
    n, k = d.shape
    dev = points.device
    dropped = points_valid & ~v.any(1)
    n_drop = int(dropped.sum())
    qidx = torch.nonzero(dropped)[:max_rescue, 0]
    r = qidx.shape[0]
    if r:
        kk = k + 1 if exclude_self else k
        q = points[qidx]
        q2 = _sq_norm(q)[:, None]
        inf = torch.full((), float("inf"), device=dev)
        cds, cis = [], []
        for base in range(0, n, 1 << 16):
            kp = points[base:base + (1 << 16)]
            kv = points_valid[base:base + (1 << 16)]
            d2c = torch.where(kv[None, :], q2 + _sq_norm(kp)[None, :]
                              - 2.0 * (q @ kp.T), inf)
            cd, ci = smallest_k(d2c, min(kk, kp.shape[0]))
            cds.append(cd)
            cis.append(ci + base)
        cd, pos = smallest_k(torch.cat(cds, 1), kk)
        ri = torch.gather(torch.cat(cis, 1), 1, pos)
        rv = torch.isfinite(cd)
        rd = torch.where(rv, cd.clamp_min(0.0), torch.zeros((), device=dev))
        if exclude_self:
            # The query's own index sorts first up to ties: shift it out.
            keep = ri != qidx[:, None]
            order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
            rd = torch.gather(rd, 1, order)[:, :k]
            ri = torch.gather(ri, 1, order)[:, :k]
            rv = torch.gather(rv & keep, 1, order)[:, :k]
        d, i, v = d.clone(), i.clone(), v.clone()
        d[qidx], i[qidx], v[qidx] = rd, ri, rv
    return d, i, v, max(n_drop - max_rescue, 0)


def brick_knn(points: torch.Tensor, k: int,
              points_valid: torch.Tensor | None = None,
              exclude_self: bool = False, slots: int = 32,
              chunk_cells: int = 2048, cell_scale: float = 1.4,
              max_cells: int | None = None, use_pallas: bool | None = None,
              return_dropped: bool = False, rescue: bool = False,
              max_rescue: int = 1024):
    """High-recall brick-grid self-query KNN (module docstring).

    ``slots`` is the static per-cell capacity (overflow points lose their
    neighbour rows); ``cell_scale`` widens cells beyond the sampled
    k-th-NN distance; ``max_cells`` bounds the occupied-cell budget
    (default n/8 + 1024).

    ``use_pallas`` (the JAX package's name for the kernel path): None takes
    the kernel path (:mod:`.brickknn_kernel`) for a CUDA tensor when
    ``slots == 32``, ``k ≤ 32`` and ``n ≤ 2²⁴``, the dense form otherwise
    (for a CUDA tensor that misses them with a logged warning naming the
    condition: the JAX package's routing, which the CUDA kernel itself
    would not need for n); True forces the kernel path (on a CPU tensor it
    runs the kernel's plain version) and raises if those conditions fail.
    The kernel path returns exact d², ties to the smaller index.

    ``return_dropped`` also returns the count of points lost to slot or
    budget overflow (their rows are all-False); ``rescue`` runs the exact
    second pass over up to ``max_rescue`` of them, and the count is then
    what remains. A non-zero count is logged as a warning."""
    from . import brickknn_kernel  # it imports this module's grid steps

    points = points.to(torch.float32)
    n = points.shape[0]
    if points_valid is None:
        points_valid = torch.ones(n, dtype=torch.bool, device=points.device)
    if 27 * slots < k + (1 if exclude_self else 0):
        raise ValueError(f"slots {slots} too small for k={k}")
    if max_cells is None:
        max_cells = n // 8 + 1024
    forced = use_pallas is not None and bool(use_pallas)
    if use_pallas is None:
        use_pallas = points.device.type == "cuda"
    if use_pallas:
        misfit = kernel_misfit(slots, k, n)
        if misfit:
            if forced:
                raise ValueError(f"use_pallas=True but the brick kernel "
                                 f"requires {misfit}")
            log.warning("brick_knn: the kernel path requires %s; running "
                        "the dense PyTorch form on %s instead", misfit,
                        points.device)
            use_pallas = False
    scale_x100 = int(round(cell_scale * 100))
    if use_pallas:
        d, i, v, n_dropped = brickknn_kernel.brick_knn_kernel_path(
            points, points_valid, k, exclude_self, scale_x100, max_cells)
    else:
        cc = min(chunk_cells, max(256, max_cells))
        if max_cells % cc:  # the JAX package's divisor-friendly budget
            max_cells = ((max_cells + cc - 1) // cc) * cc
        d, i, v, n_dropped = _brick_knn_impl(
            points, points_valid, k, slots, exclude_self, scale_x100,
            max_cells)
    if rescue:
        d, i, v, n_dropped = _rescue_dropped(
            points, points_valid, d, i, v, exclude_self=exclude_self,
            max_rescue=max_rescue)
    _warn_dropped(n_dropped, n)
    if return_dropped:
        return d, i, v, int(n_dropped)
    return d, i, v


def kernel_misfit(slots: int, k: int, n: int) -> str:
    """The brick kernel path's fit conditions, those of the JAX package:
    "" when ``slots == 32``, ``k ≤ 32`` and ``n ≤ 2²⁴`` hold, else which
    of them fail."""
    from .brickknn_kernel import MAX_K, MAX_N

    failed = [f"{name} (got {got})" for name, got, ok in (
        (f"slots={S_KERNEL}", slots, slots == S_KERNEL),
        (f"k<={MAX_K}", k, k <= MAX_K),
        (f"n<={MAX_N}", n, n <= MAX_N)) if not ok]
    return " and ".join(failed)


def _warn_dropped(n_dropped, n_total) -> None:
    nd = int(n_dropped)
    if nd > 0:
        log.warning(
            "brick_knn dropped %d/%d points (cell-slot overflow or cell "
            "budget); they report zero neighbors — raise `slots`/"
            "`max_cells` for full coverage", nd, int(n_total))

