"""DBSCAN clustering — keep-largest-cluster cleanup (counterpart of the JAX
``ops/cluster.py``).

Replaces Open3D ``cluster_dbscan`` as the reference's outlier lab uses it
(`Old/StatisticalOutlierRemoval.py:5-32`: eps=5, min_points=200, keep the
biggest cluster). DBSCAN as min-label propagation on the ε-neighbourhood
graph:

1. ε-neighbourhoods from the exact KNN, capped at ``max_nn`` edges per
   point (the cap only ever splits a cluster, never merges two);
2. core points have ≥ ``min_points`` neighbours, self included;
3. every core point starts labelled with its own index; each sweep takes
   the min label over itself and its core neighbours, both along the
   directed KNN edges and against them (a scatter-min), so the truncated
   lists act as an undirected graph. Sweeps repeat until nothing changes —
   a Python loop that reads its change flag once per sweep (the JAX
   package's ``while_loop``);
4. border points take the min label among their core neighbours; the rest
   is noise (−1).
"""

from __future__ import annotations

import torch

from .knn import knn


def dbscan(points: torch.Tensor, eps: float, min_points: int = 200,
           valid: torch.Tensor | None = None, max_nn: int = 64):
    """Returns (labels (N,) int32, n_clusters int). Noise and invalid
    points are −1; labels are compacted to 0..n_clusters−1 in order of
    each cluster's smallest index."""
    pts = points.to(torch.float32)
    n = pts.shape[0]
    dev = pts.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    d2, idx, nbv = knn(pts, max_nn, points_valid=valid)
    in_eps = nbv & (d2 <= eps * eps)                   # (N, K), self included
    core = valid & (in_eps.sum(1) >= min_points)
    big = torch.full((), n, dtype=torch.int64, device=dev)  # "no label"
    own = torch.arange(n, device=dev)
    labels = torch.where(core, own, big)
    rows = own[:, None].expand_as(idx)
    edge_ok = in_eps & core[:, None] & core[idx]       # core–core edges only
    flat_idx = idx.reshape(-1)
    while True:
        nb_lab = torch.where(edge_ok, labels[idx], big)
        fwd = torch.minimum(labels, nb_lab.min(1).values)
        src_lab = torch.where(edge_ok, fwd[rows], big)
        rev = torch.full((n,), n, dtype=torch.int64, device=dev)
        rev.scatter_reduce_(0, flat_idx, src_lab.reshape(-1), reduce="amin")
        new = torch.where(core, torch.minimum(fwd, rev), big)
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break

    # Border points: min label among their core ε-neighbours.
    border = torch.where(in_eps & core[idx], labels[idx], big).min(1).values
    full = torch.where(core, labels,
                       torch.where(valid & (border < big), border, big))
    is_root = core & (labels == own)
    compact = torch.cumsum(is_root.to(torch.int64), 0) - 1
    out = torch.where(full < big, compact[full.clamp(0, n - 1)],
                      torch.full((), -1, device=dev))
    return out.to(torch.int32), int(is_root.sum())


def keep_largest_cluster(points: torch.Tensor, eps: float,
                         min_points: int = 200,
                         valid: torch.Tensor | None = None,
                         max_nn: int = 64) -> torch.Tensor:
    """The reference's cleanup recipe (`Old/StatisticalOutlierRemoval.py:
    5-32`): cluster, keep only the most populous cluster (the first on a
    tie). Returns the surviving mask; an all-noise cloud keeps every valid
    point, like the reference's early return."""
    n = points.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=points.device)
    labels, n_clusters = dbscan(points, eps, min_points, valid, max_nn)
    if n_clusters == 0:
        return valid
    counts = torch.zeros(n, dtype=torch.int64, device=points.device)
    counts.index_add_(0, labels.clamp(0, n - 1).to(torch.int64),
                      (labels >= 0).to(torch.int64))
    return valid & (labels == torch.argmax(counts))
