"""The brick-grid KNN kernel path (counterpart of the JAX
``ops/brickknn_pallas.py``): the set-up around the kernel and the kernel's
wrapper, :func:`brick_knn_cells`.

1. the shared cell assignment (:func:`.brickknn._grid_cells`), then the
   occupancy retarget: the r_k cell edge packs surface clouds at a few
   points per cell, so the edge grows until the p99.5 per-point occupancy
   fills ~28 of the 32 slots (the packing exponent measured from a probe
   at h and 2h), at least enough to fit the cell budget, at most 4×;
2. the stable sort into 32-slot bricks of (x, y, z, global id) — an empty
   slot has +inf coordinates and id −1 — and each point's brick row;
3. the neighbour table: 13 directed deltas looked up by
   ``torch.searchsorted``, the other 13 by symmetry (if B is A's neighbour
   at d, A is B's at −d), the cell itself at the centre; then compacted
   present-first, nearest first (the cell, its face, edge and corner
   neighbours), ``nnb`` entries per cell;
4. the kernel over the occupied cells: for each query slot the k smallest
   (d², id) pairs among its cell's ``nnb · 32`` candidates, exact d²
   (rounded operation by operation), ties to the smaller id, in brick
   order;
5. one row gather back to point order.

On a CUDA tensor :func:`brick_knn_cells` launches ``csrc/brick_knn.cu``;
on a CPU tensor it takes the plain version :func:`brick_knn_cells_plain`.
The two are bit-equal.

Differences from the TPU kernel, which the JAX package's tests allow: it
cleared the low 10 mantissa bits of d² to pack the candidate lane there
and broke ties by lane; this path returns exact d² with ties to the
smaller global id. It needs no 2²⁴ cap on the ids, but keeps the JAX
package's fit conditions (k ≤ 32, n ≤ 2²⁴) so both packages route the same
inputs alike.
"""

from __future__ import annotations

import torch

from .brickknn import _BIG, _BITS, _GRID_MAX, _grid_cells, _sorted_segments
from .gridknn import _DELTAS

S = 32            # brick slots (queries and candidates per cell)
NB = 27           # the 3³ neighbour window
MAX_K = 32
MAX_N = 1 << 24   # the JAX package's cap (its ids travel as exact f32)
CP = 4            # the JAX package rounds the cell budget to this multiple
_INF_BITS = 0x7F800000
_PLAIN_CHUNK = 512  # cells per block of the plain version
# Order of the 27 window slots in the neighbour table: the cell itself, its
# 6 face, 12 edge and 8 corner neighbours, each class in slot order. The
# kernel meets the nearest candidates first, so its k-th distance tightens
# early; the result is the same in any order.
_NEAREST_FIRST = [sum(c != 0 for c in d) * NB + s
                  for s, d in enumerate(_DELTAS)]


def _check(bricks, nbr, nnb, k: int) -> None:
    c = bricks.shape[0]
    if bricks.shape != (c, S, 4) or nbr.shape != (c, NB) \
            or nnb.shape != (c,):
        raise ValueError(
            f"brick_knn_cells takes bricks (C, {S}, 4), nbr (C, {NB}) and "
            f"nnb (C,); got {tuple(bricks.shape)}, {tuple(nbr.shape)}, "
            f"{tuple(nnb.shape)}")
    for name, t in (("bricks", bricks), ("nbr", nbr), ("nnb", nnb)):
        if t.dtype != torch.int32:
            raise ValueError(f"brick_knn_cells: {name} must be int32, got "
                             f"{t.dtype}")
        if t.device != bricks.device:
            raise ValueError(f"brick_knn_cells: {name} is on {t.device}, "
                             f"bricks on {bricks.device}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"brick_knn_cells: k must be in 1..{MAX_K}, got {k}")


def brick_knn_cells_plain(bricks: torch.Tensor, nbr: torch.Tensor,
                          nnb: torch.Tensor, k: int, exclude_self: bool):
    """Plain PyTorch version of :func:`brick_knn_cells`, in blocks of cells:
    gather each cell's (27·32) candidates, d² = (dx·dx + dy·dy) + dz·dz,
    rank by one int64 key of the d² bits above the id."""
    c_all = bricks.shape[0]
    dev = bricks.device
    coords = bricks[..., :3].contiguous().view(torch.float32)   # (C, S, 3)
    ids = bricks[..., 3]                                         # (C, S)
    inf = torch.full((), float("inf"), device=dev)
    none = torch.full((), torch.iinfo(torch.int64).max, dtype=torch.int64,
                      device=dev)
    out_d = torch.empty((c_all * S, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((c_all * S, k), dtype=torch.int32, device=dev)
    slot = torch.arange(NB, device=dev)
    for c0 in range(0, c_all, _PLAIN_CHUNK):
        c1 = min(c0 + _PLAIN_CHUNK, c_all)
        c = c1 - c0
        nb = nbr[c0:c1].to(torch.int64)
        live = (slot[None, :] < nnb[c0:c1, None])[:, :, None].expand(
            c, NB, S).reshape(c, 1, NB * S)
        kp = coords[nb].reshape(c, 1, NB * S, 3)
        kid = ids[nb].reshape(c, 1, NB * S)
        q = coords[c0:c1][:, :, None, :]
        dx = q[..., 0] - kp[..., 0]
        dy = q[..., 1] - kp[..., 1]
        dz = q[..., 2] - kp[..., 2]
        d2 = (dx * dx + dy * dy) + dz * dz                 # (c, S, 27·S)
        ok = live & (d2 < inf)
        if exclude_self:
            ok = ok & (kid != ids[c0:c1][:, :, None])
        key = (d2.view(torch.int32).to(torch.int64) << 32) \
            | kid.to(torch.int64)
        key = torch.where(ok, key, none).reshape(c * S, NB * S)
        vals = torch.topk(key, k, dim=1, largest=False, sorted=True).values
        hit = vals != none
        out_d[c0 * S:c1 * S] = torch.where(
            hit, (vals >> 32).to(torch.int32).view(torch.float32), inf)
        out_i[c0 * S:c1 * S] = torch.where(
            hit, (vals & 0xFFFFFFFF).to(torch.int32),
            torch.full((), -1, dtype=torch.int32, device=dev))
    return out_d, out_i


def brick_knn_cells(bricks: torch.Tensor, nbr: torch.Tensor,
                    nnb: torch.Tensor, k: int, exclude_self: bool):
    """For each of C cells and each of its 32 query slots, the k nearest of
    the cell's candidates: bricks (C, 32, 4) int32 rows of (x, y, z bits,
    global id) — an empty slot has +inf coordinates and id −1 — nbr (C, 27)
    int32 neighbour cells (indices into ``bricks``; the first ``nnb`` are
    the present ones), nnb (C,) int32. Returns d² (C·32, k) float32
    ascending and ids (C·32, k) int32, ties to the smaller id, with the
    query's own id skipped when ``exclude_self``; a missing neighbour is
    (+inf, −1).

    A CUDA tensor launches ``sl_brick_knn`` (``csrc/brick_knn.cu``) and
    raises if it cannot; only a CPU tensor takes
    :func:`brick_knn_cells_plain`."""
    _check(bricks, nbr, nnb, k)
    if bricks.device.type == "cpu":
        return brick_knn_cells_plain(bricks, nbr, nnb, k, exclude_self)
    if bricks.device.type != "cuda":
        raise ValueError(f"brick_knn_cells has no kernel for {bricks.device}")
    if not (bricks.is_contiguous() and nbr.is_contiguous()
            and nnb.is_contiguous()):
        raise ValueError("brick_knn_cells needs contiguous operands")
    if bricks.data_ptr() % 16:
        raise ValueError("brick_knn_cells reads bricks as 16-byte rows: "
                         "they must start on a 16-byte boundary")
    c = bricks.shape[0]
    out_d = torch.empty((c * S, k), dtype=torch.float32, device=bricks.device)
    out_i = torch.empty((c * S, k), dtype=torch.int32, device=bricks.device)
    from ..kernels import build

    lib = build.library()
    with torch.cuda.device(bricks.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sl_brick_knn(bricks.data_ptr(), nbr.data_ptr(),
                               nnb.data_ptr(), c, int(k), int(exclude_self),
                               out_d.data_ptr(), out_i.data_ptr(), stream)
    build.check(err, "sl_brick_knn")
    brick_knn_cells.launches += 1
    return out_d, out_i


brick_knn_cells.launches = 0


def _occupancy(cid_sorted, n: int):
    """p99.5 per-point cell occupancy (≥ 1) and the occupied-cell count of
    one sorted cell assignment, both float32 0-d tensors."""
    dev = cid_sorted.device
    vs = cid_sorted < _BIG
    firstp = torch.cat([cid_sorted[:1] < _BIG,
                        (cid_sorted[1:] != cid_sorted[:-1]) & vs[1:]])
    rankp = torch.cumsum(firstp.to(torch.int64), 0) - 1
    # torchlint: disable=atomic-scatter -- int64 counts repeat in any order
    counts = torch.zeros(n + 1, dtype=torch.int64, device=dev).index_add_(
        0, torch.where(vs, rankp, torch.full((), n, device=dev)),
        torch.ones(n, dtype=torch.int64, device=dev))
    cpp = torch.where(vs, counts[rankp.clamp_max(n - 1)], 0)
    # Invalid points go to bin 257, outside the scanned range.
    # torchlint: disable=atomic-scatter -- int64 counts repeat in any order
    hist = torch.zeros(258, dtype=torch.int64, device=dev).index_add_(
        0, torch.where(vs, cpp.clamp_max(256), 257),
        torch.ones(n, dtype=torch.int64, device=dev))
    nv = vs.sum().clamp_min(1).to(torch.int32)
    cum = torch.cumsum(hist[:257], 0)
    occ_hi = torch.argmax((cum >= (0.995 * nv).to(torch.int32)).to(
        torch.int8))
    return (occ_hi.clamp_min(1).to(torch.float32),
            firstp.sum().to(torch.float32))


def _neighbor_table(ucid, m_cells: int):
    """(M, 27) neighbour ranks, present ones first and nearest first
    (``_NEAREST_FIRST``; absent → the cell's own rank), and (M,) present
    counts, from the ascending occupied-id table."""
    dev = ucid.device
    ux = ucid >> (2 * _BITS)
    uy = (ucid >> _BITS) & _GRID_MAX
    uz = ucid & _GRID_MAX
    pos_deltas = torch.tensor(_DELTAS[14:], dtype=torch.int32, device=dev)
    nxyz = torch.stack([ux, uy, uz], -1)[:, None, :] + pos_deltas[None]
    in_grid = ((nxyz >= 0) & (nxyz <= _GRID_MAX)).all(-1) \
        & (ucid < _BIG)[:, None]
    ncid = (nxyz[..., 0] << (2 * _BITS)) | (nxyz[..., 1] << _BITS) \
        | nxyz[..., 2]
    ncid_q = torch.where(in_grid, ncid, torch.full((), _BIG,
                                                   dtype=torch.int32,
                                                   device=dev))
    # Table entries ≤ each query: the JAX package's sort-merge rank.
    c13 = torch.searchsorted(ucid, ncid_q.reshape(-1).contiguous(),
                             right=True).reshape(ncid.shape)
    pos_c = (c13 - 1).clamp(0, m_cells - 1)
    found = in_grid & (c13 > 0) & (ucid[pos_c] == ncid)
    own = torch.arange(m_cells, device=dev)
    absent = torch.full((), m_cells, device=dev)
    nbr27 = torch.full((m_cells, NB), m_cells, dtype=torch.int64, device=dev)
    # The centre only for occupied ranks: a ghost cell ends with nnb == 0.
    nbr27[:, 13] = torch.where(ucid < _BIG, own, absent)
    nbr27[:, 14:] = torch.where(found, pos_c, absent)
    # Mirror: B at directed delta d (slot 14+d) of A ⇒ A at slot 12−d of B.
    mslot = torch.arange(12, -1, -1, device=dev)
    mdest = torch.where(found, pos_c * NB + mslot[None, :],
                        torch.full((), m_cells * NB, device=dev))
    flat = torch.cat([nbr27.reshape(-1), nbr27.new_zeros(1)])
    flat[mdest.reshape(-1)] = own[:, None].expand(m_cells, 13).reshape(-1)
    nbr27 = flat[:-1].reshape(m_cells, NB)
    present = nbr27 < m_cells
    key = torch.where(present, torch.tensor(_NEAREST_FIRST, dtype=torch.int64,
                                             device=dev)[
        None, :], 4 * NB)
    order2 = torch.argsort(key, dim=1, stable=True)
    nbr_c = torch.gather(nbr27, 1, order2)
    nnb = present.sum(1)
    nbr_c = torch.where(nbr_c < m_cells, nbr_c, own[:, None])
    return nbr_c, nnb


def kernel_inputs(points, valid, k: int, cell_scale_x100: int,
                  max_cells: int):
    """The set-up of the kernel path (module docstring steps 1-3): the
    kernel's operands over the occupied cells — bricks (C, 32, 4) int32,
    nbr (C, 27) int32, nnb (C,) int32 — each point's brick row
    ``gatherpos`` (N,) (``C·32`` or more for a dropped point) and the drop
    count. ``max_cells`` is rounded up to a multiple of 4 as the JAX
    package does."""
    n = points.shape[0]
    dev = points.device
    m_cells = ((max_cells + CP - 1) // CP) * CP

    h, quantize = _grid_cells(points, valid, k, cell_scale_x100)
    occ0, cells0 = _occupancy(torch.sort(quantize(h)).values, n)
    occ2, _ = _occupancy(torch.sort(quantize(2.0 * h)).values, n)
    beta_p = torch.log2(torch.maximum(occ2, occ0 * 1.1) / occ0).clamp(1.5,
                                                                      3.0)
    # A Python-scalar numerator would become a reciprocal multiply.
    one = torch.ones((), device=dev)
    s_pack = torch.div(28.0 * one, occ0).clamp_min(1.0) ** torch.div(
        one, beta_p)
    # cells(h·s) ≤ cells0 / s² for any geometry with β ≥ 2.
    s_budget = torch.sqrt(cells0 / torch.full((), 0.95 * m_cells,
                                              device=dev))
    h = h * torch.maximum(s_pack, s_budget).clamp(1.0, 4.0)
    cid = quantize(h)
    (_, pts_s, val_s, orig_s, first, _, ok, dest,
     ucid) = _sorted_segments(points, valid, cid, S, m_cells)

    # Bricks of (x, y, z, id) as int32 bits; empty slots (+inf³, −1).
    rows = torch.cat([pts_s.contiguous().view(torch.int32),
                      orig_s.to(torch.int32)[:, None]], 1)
    b4 = torch.tensor([_INF_BITS] * 3 + [-1], dtype=torch.int32,
                      device=dev).repeat(m_cells * S + 1, 1)
    b4[dest] = rows
    # Point order → brick row; dropped points land on the dump row.
    gatherpos = torch.full((n + 1,), m_cells * S, dtype=torch.int64,
                           device=dev)
    gatherpos[torch.where(ok, orig_s, torch.full((), n, device=dev))] = dest
    nbr_c, nnb = _neighbor_table(ucid, m_cells)
    # Occupied cells are a prefix of the ranks, and every neighbour of one
    # is occupied: the kernel runs over that prefix only.
    m_occ = min(int(first.sum()), m_cells)
    return (b4[:m_occ * S].reshape(m_occ, S, 4),
            nbr_c[:m_occ].to(torch.int32).contiguous(),
            nnb[:m_occ].to(torch.int32).contiguous(),
            gatherpos[:n], (val_s & ~ok).sum())


def brick_knn_kernel_path(points, valid, k: int, exclude_self: bool,
                          cell_scale_x100: int, max_cells: int):
    """The kernel path of :func:`.brickknn.brick_knn`: (d (N, k), idx (N, k)
    int64, nb_valid (N, k), n_dropped)."""
    if k > MAX_K:
        raise ValueError(f"the brick kernel caps k at {MAX_K}, got {k}")
    n = points.shape[0]
    if n > MAX_N:
        raise ValueError(f"the brick kernel path caps n at {MAX_N}, got {n}")
    dev = points.device
    bricks, nbr, nnb, gatherpos, n_dropped = kernel_inputs(
        points, valid, k, cell_scale_x100, max_cells)
    m_occ = bricks.shape[0]
    d, i = brick_knn_cells(bricks, nbr, nnb, k, exclude_self)
    # Back to point order: one row gather.
    in_brick = gatherpos < m_occ * S
    gp = gatherpos.clamp_max(max(m_occ * S - 1, 0))
    if m_occ:
        out_d, out_i = d[gp], i[gp].to(torch.int64)
    else:
        out_d = torch.zeros((n, k), dtype=torch.float32, device=dev)
        out_i = torch.zeros((n, k), dtype=torch.int64, device=dev)
    out_v = torch.isfinite(out_d) & valid[:, None] & in_brick[:, None]
    out_d = torch.where(out_v, out_d, torch.zeros((), device=dev))
    out_i = torch.where(out_v, out_i, 0).clamp(0, n - 1)
    return out_d, out_i, out_v, n_dropped
