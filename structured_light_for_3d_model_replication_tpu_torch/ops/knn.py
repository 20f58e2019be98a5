"""Exact k-nearest-neighbour search as dense tiled linear algebra
(counterpart of the JAX ``ops/knn.py``; 3-D geometry and 33-D FPFH feature
matching share it).

Selection uses the same ‖q‖² + ‖p‖² − 2 q·p fp32 expansion as the JAX
package's ``_block_dists`` — the q·pᵀ term is a matmul — over the same key
tiles, with invalid keys at +inf, a carried :func:`smallest_k` merge (or a
running ``argmin`` for k = 1) and ties to the lower index; the selected
distances are then recomputed by direct difference and stably re-sorted.
So neighbour sets match the JAX package's exact path.

Difference from the JAX package: its ``method="auto"`` takes the
approximate ``lax.approx_min_k`` path on a TPU (recall ≈ 0.95). The port
has only the exact method, on the card as well as on the host.
"""

from __future__ import annotations

import torch


def check_neighbors(neighbors, n: int, width: int) -> None:
    """Validate a precomputed ``(d2, idx, nb_valid)`` sweep against its
    consumer's cloud length and required column count."""
    for a in neighbors:
        shape = tuple(a.shape)
        if len(shape) != 2 or shape[0] != n or shape[1] < width:
            raise ValueError(
                f"precomputed neighbors shape {shape} incompatible with "
                f"cloud n={n}, required width={width}")


def pad_points(points: torch.Tensor, valid: torch.Tensor | None,
               multiple: int):
    """Pad (..., N, D) points (+ valid mask) to a multiple of N; padding is
    invalid."""
    lead, (n, dim) = points.shape[:-2], points.shape[-2:]
    if valid is None:
        valid = torch.ones(lead + (n,), dtype=torch.bool, device=points.device)
    pad = (-n) % multiple
    if pad:
        points = torch.cat([points, points.new_zeros(lead + (pad, dim))], -2)
        valid = torch.cat([valid, valid.new_zeros(lead + (pad,))], -1)
    return points, valid


def rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` over any leading batch axes: (..., N, D) rows picked
    by (..., *S) indices into each batch's own table → (..., *S, D)."""
    lead = table.shape[:-2]
    flat = idx.reshape(lead + (-1, 1)).expand(lead + (-1, table.shape[-1]))
    return torch.gather(table, -2, flat).reshape(idx.shape + table.shape[-1:])


def smallest_k(d: torch.Tensor, k: int):
    """The k smallest entries of each row of float32 ``d``, ascending, ties
    to the lower position — the JAX package's ``top_k`` order (plain
    ``torch.topk`` breaks ties arbitrarily). Each entry becomes one int64
    key, the float's bits (made order-preserving for negatives) above its
    column index. Returns (values, positions)."""
    bits = d.contiguous().view(torch.int32).to(torch.int64)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    key = (bits << 32) | torch.arange(d.shape[-1], device=d.device)
    _, pos = torch.topk(key, k, dim=-1, largest=False, sorted=True)
    return torch.gather(d, -1, pos), pos


def _select(q, kp, kv, p2, k, k_tile):
    """Top-k (smallest) of one query tile against all keys, by the matmul
    expansion, one key tile at a time: a running argmin for k = 1 (earlier
    tiles win ties), else a carried top-k merge — the JAX package's tiling,
    so the float32 products are formed over the same shapes. Any leading
    batch axes of ``q``, ``kp``, ``kv`` and ``p2`` are carried through."""
    q2 = torch.sum(q * q, dim=-1, keepdim=True)
    inf = torch.full((), float("inf"), device=q.device)
    best_d = best_i = None
    for s in range(0, kp.shape[-2], k_tile):
        d = q2 + p2[..., None, s:s + k_tile] - 2.0 * (
            q @ kp[..., s:s + k_tile, :].transpose(-1, -2))
        d = torch.where(kv[..., None, s:s + k_tile], d, inf)
        if k == 1:
            j = torch.argmin(d, dim=-1, keepdim=True)
            dd = torch.gather(d, -1, j)
            j = j + s
            if best_d is None:
                best_d, best_i = dd, j
            else:
                better = dd < best_d
                best_d = torch.where(better, dd, best_d)
                best_i = torch.where(better, j, best_i)
            continue
        idx = torch.arange(s, s + d.shape[-1], device=q.device).expand_as(d)
        if best_d is not None:
            d = torch.cat([best_d, d], dim=-1)
            idx = torch.cat([best_i, idx], dim=-1)
        best_d, o = smallest_k(d, k)
        best_i = torch.gather(idx, -1, o)
    return best_d, best_i


def knn(points: torch.Tensor, k: int, queries: torch.Tensor | None = None,
        points_valid: torch.Tensor | None = None,
        queries_valid: torch.Tensor | None = None,
        exclude_self: bool = False, q_tile: int = 1024,
        live: tuple[int, int] | None = None):
    """k nearest points for each query (defaults: queries = points).

    Returns (sq_dists (M, k), indices (M, k) int64, neighbor_valid (M, k)),
    distances ascending. Invalid points never appear as neighbours; when
    fewer than k valid points exist, surplus slots have neighbor_valid False
    (distance reported as 0). With ``exclude_self`` the query's own index is
    dropped (Open3D's SOR convention). Leading batch axes — (..., N, D)
    points, (..., M, D) queries, each batch searched in its own points —
    carry through to every output, the matrix products then batched.

    ``live`` = (points, queries), for one unbatched cloud whose valid
    points and queries all lie in those leading rows (a voxel-downsampled
    cloud's cells come first): the sweep covers those rows alone, and every
    row past them comes back neighbourless (index 0, distance 0, invalid).
    The live rows are the dense sweep's bit for bit: the same tiles, less
    trailing key tiles that hold only invalid keys (+inf), which never
    displace a selection."""
    if live is not None:
        return _knn_live(points, k, queries, points_valid, queries_valid,
                         exclude_self, q_tile, live)
    self_query = queries is None
    if self_query:
        queries, queries_valid = points, points_valid
    kk = k + 1 if (exclude_self and self_query) else k
    n_q = queries.shape[-2]
    k_tile = 8192 if kk == 1 else 2048
    p_pad, pv_pad = pad_points(points.to(torch.float32), points_valid, k_tile)
    q_pad, _ = pad_points(queries.to(torch.float32), None, q_tile)
    p2 = torch.sum(p_pad * p_pad, dim=-1)

    ds, is_ = [], []
    for s in range(0, n_q, q_tile):
        q = q_pad[..., s:s + q_tile, :]
        best_d, best_i = _select(q, p_pad, pv_pad, p2, kk, k_tile)
        # The expansion loses ~|q|·|p|·eps to cancellation; the k selected
        # distances are recomputed by direct difference and re-sorted.
        diff = q[..., None, :] - rows(p_pad, best_i)
        exact = torch.sum(diff * diff, dim=-1)
        best_d = torch.where(torch.isfinite(best_d), exact, best_d)
        if kk > 1:
            order = torch.argsort(best_d, dim=-1, stable=True)
            best_d = torch.gather(best_d, -1, order)
            best_i = torch.gather(best_i, -1, order)
        ds.append(best_d)
        is_.append(best_i)
    d = torch.cat(ds, -2)[..., :n_q, :].clamp_min(0.0)
    i = torch.cat(is_, -2)[..., :n_q, :]

    if exclude_self and self_query:
        own = torch.arange(n_q, device=i.device)[:, None]
        order = torch.argsort((i == own).to(torch.int8), dim=-1, stable=True)
        d = torch.gather(d, -1, order)[..., :k]
        i = torch.gather(i, -1, order)[..., :k]

    finite = torch.isfinite(d)
    nb_valid = finite
    if queries_valid is not None:
        nb_valid = nb_valid & queries_valid[..., :n_q, None]
    return torch.where(finite, d, torch.zeros((), device=d.device)), i, nb_valid


def _knn_live(points, k, queries, points_valid, queries_valid, exclude_self,
              q_tile, live):
    """:func:`knn` over the ``live`` leading rows, the rest padded."""
    if points.dim() != 2:
        raise ValueError("knn: live takes one unbatched cloud")
    self_query = queries is None
    n_p, n_q = (max(1, int(n)) for n in live)
    if self_query:
        if n_p != n_q:
            raise ValueError(f"knn: a self-query's live counts differ {live}")
        queries_valid = points_valid
    full = (points if self_query else queries).shape[0]
    d, i, v = knn(points[:n_p], k,
                  None if self_query else queries[:n_q],
                  None if points_valid is None else points_valid[:n_p],
                  None if queries_valid is None or self_query
                  else queries_valid[:n_q],
                  exclude_self, q_tile)
    pad = full - d.shape[0]
    return (torch.cat([d, d.new_zeros(pad, d.shape[1])]),
            torch.cat([i, i.new_zeros(pad, i.shape[1])]),
            torch.cat([v, v.new_zeros(pad, v.shape[1])]))
