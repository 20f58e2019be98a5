"""Point-cloud cleanup (counterpart of the JAX ``ops/pointcloud.py``):
voxel downsample, stratified and random subsamples, statistical and radius
outlier removal and PCA normals with the closed-form 3×3 eigensolver, over
the self-query KNN dispatch :func:`_self_knn`.

Static shapes as in the JAX package: clouds are dense (N, 3) tensors plus a
validity mask, "removing" a point clears its mask bit, and voxel
downsampling emits N output slots with a mask.
"""

from __future__ import annotations

import math

import torch

from .._device import div
from ._scatter import segment_sum
from .brickknn import brick_knn
from .brickknn_kernel import MAX_K as _BRICK_MAX_K
from .brickknn_kernel import MAX_N as _BRICK_MAX_N
from .gridknn import grid_knn
from .knn import check_neighbors, knn
from .mortonknn import morton_knn

# Above this many points, self-query neighbourhoods leave the dense O(N²)
# sweep for a spatial engine.
APPROX_KNN_THRESHOLD = 131_072


def _auto_method(n: int, k: int, device) -> str:
    """The ``"auto"`` rule of :func:`_self_knn`, as the JAX package routes on
    and off its accelerator: ``dense`` below :data:`APPROX_KNN_THRESHOLD`
    points; above it, on a CUDA device ``rescue`` when k ≤ 32 and n ≤ 2²⁴
    (the brick kernel's fit) else ``morton``, on the CPU ``morton``."""
    if n < APPROX_KNN_THRESHOLD:
        return "dense"
    if torch.device(device).type == "cuda":
        return "rescue" if k <= _BRICK_MAX_K and n <= _BRICK_MAX_N \
            else "morton"
    return "morton"


def _self_knn(points, k, valid, exclude_self, method="auto"):
    """Self-query KNN dispatch.

    ``dense``  — exact tiled matmul (ops/knn.py), O(N²);
    ``morton`` — Morton-blocked approximate (ops/mortonknn.py);
    ``rescue`` — brick-grid engine (ops/brickknn.py), recall ≥ 0.99; on a
                 CUDA tensor its kernel path (``csrc/brick_knn.cu``);
    ``grid``   — 27-cell spatial grid (ops/gridknn.py);
    ``auto``   — :func:`_auto_method`."""
    if method == "auto":
        method = _auto_method(points.shape[0], k, points.device)
    if method == "morton":
        return morton_knn(points, k, points_valid=valid,
                          exclude_self=exclude_self)
    if method == "rescue":
        return brick_knn(points, k, points_valid=valid,
                         exclude_self=exclude_self)
    if method == "grid":
        return grid_knn(points, k, points_valid=valid,
                        exclude_self=exclude_self)
    if method != "dense":
        raise ValueError(f"unknown neighbor method {method!r}")
    return knn(points, k, points_valid=valid, exclude_self=exclude_self)


# ---------------------------------------------------------------------------
# Voxel downsample
# ---------------------------------------------------------------------------


def voxel_downsample(points: torch.Tensor, voxel_size: float,
                     valid: torch.Tensor | None = None,
                     attrs: torch.Tensor | None = None):
    """Average points (and optional per-point attributes) per voxel cell.

    Returns ``(out_points (N,3), out_attrs or None, out_valid (N,),
    n_cells)`` — one output slot per input point, the first ``n_cells``
    slots holding one cell centroid each (cells in lexicographic cell
    order), the rest masked off."""
    n = points.shape[0]
    dev = points.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    pts = points.to(torch.float32)
    cell = torch.floor(div(pts, float(voxel_size))).to(torch.int32)
    # Invalid points get an out-of-band cell so they sort last, together.
    cell = torch.where(valid[:, None], cell,
                       torch.full((), 2**30, dtype=torch.int32, device=dev))
    # Lexicographic (x, y, z) order: three stable sorts, last key first.
    order = torch.argsort(cell[:, 2], stable=True)
    order = order[torch.argsort(cell[order, 1], stable=True)]
    order = order[torch.argsort(cell[order, 0], stable=True)]
    cs = cell[order]
    vs = valid[order]
    ps = pts[order]

    new_cell = torch.any(cs != torch.roll(cs, 1, 0), dim=1)
    new_cell[0] = True
    group = torch.cumsum(new_cell.to(torch.int64), 0) - 1

    # The rows are sorted by cell, so each cell's sum is one contiguous
    # segment (index order on the CPU, a segmented sum on the card).
    ones = vs.to(torch.float32)
    cols = [ones[:, None], ps * ones[:, None]]
    if attrs is not None:
        a = attrs.to(torch.float32)[order]
        a = a[:, None] if a.dim() == 1 else a.flatten(1)
        cols.append(a * ones[:, None])
    sums = segment_sum(torch.cat(cols, 1), group, n)
    counts = sums[:, 0]
    denom = counts.clamp_min(1.0)[:, None]
    out_points = sums[:, 1:4] / denom
    out_valid = counts > 0
    n_cells = out_valid.sum()
    out_attrs = None
    if attrs is not None:
        out_attrs = (sums[:, 4:] / denom).reshape((n,) + attrs.shape[1:])
    return out_points, out_attrs, out_valid, n_cells


# ---------------------------------------------------------------------------
# Outlier removal
# ---------------------------------------------------------------------------


def _sor_mask(mean_d, has_nb, valid, std_ratio):
    """Keep mask from per-point mean neighbour distances: drop points above
    μ + ratio·σ of the decidable points (those with ≥ 1 neighbour)."""
    decidable = valid & has_nb
    vf = decidable.to(torch.float32)
    nv = vf.sum().clamp_min(1.0)
    mu = (mean_d * vf).sum() / nv
    var = (((mean_d - mu) ** 2) * vf).sum() / nv
    thresh = mu + std_ratio * torch.sqrt(var)
    return decidable & (mean_d <= thresh), decidable


def statistical_outlier_removal(points: torch.Tensor,
                                valid: torch.Tensor | None = None,
                                nb_neighbors: int = 20,
                                std_ratio: float = 2.0,
                                neighbor_method: str = "auto"):
    """Open3D ``remove_statistical_outlier`` semantics: per point, mean
    distance to its nb nearest OTHER points; drop points whose mean exceeds
    global_mean + std_ratio · global_std. Points with no valid neighbour
    are undecidable and removed — unless every valid point is, when the
    valid set is kept. Returns the surviving mask."""
    n = points.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=points.device)
    d2, _, nbv = _self_knn(points, nb_neighbors, valid, True,
                           neighbor_method)
    d = torch.sqrt(d2)
    cnt = nbv.sum(1)
    mean_d = torch.where(nbv, d, torch.zeros((), device=d.device)).sum(1) \
        / cnt.clamp_min(1)
    keep, decidable = _sor_mask(mean_d, cnt > 0, valid, std_ratio)
    return torch.where(decidable.any(), keep, valid)


def radius_outlier_removal(points: torch.Tensor, radius: float,
                           min_neighbors: int = 5,
                           valid: torch.Tensor | None = None,
                           neighbor_method: str = "auto"):
    """Open3D ``remove_radius_outlier`` semantics
    (`Old/StatisticalOutlierRemoval.py:86`: nb=5, r=15): keep points with
    at least ``min_neighbors`` OTHER points within ``radius`` — the m-th
    nearest other point lies within it. Returns the surviving mask."""
    n = points.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=points.device)
    d2, _, nbv = _self_knn(points, min_neighbors, valid, True,
                           neighbor_method)
    return valid & nbv[:, -1] & (d2[:, -1] <= radius * radius)


# ---------------------------------------------------------------------------
# Fixed-size subsampling (static-shape compaction)
# ---------------------------------------------------------------------------


def random_subsample(points: torch.Tensor, m: int,
                     valid: torch.Tensor | None = None,
                     attrs: torch.Tensor | None = None,
                     generator: torch.Generator | None = None):
    """Uniform random subset of the VALID points, compacted to ``m`` static
    slots: valid points get uniform scores, invalid −inf, and the m largest
    are kept (all valid ones, surplus slots masked, when fewer exist).
    Returns ``(out_points (m, 3), out_attrs or None, out_valid (m,))``. The
    scores come from ``generator`` (default: one seeded 0 on the points'
    device); they differ from the JAX package's ``jax.random`` draws."""
    n = points.shape[0]
    dev = points.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    score = torch.where(valid, torch.rand(n, generator=generator, device=dev),
                        torch.full((), float("-inf"), device=dev))
    idx = torch.topk(score, m).indices
    out_valid = valid[idx]
    zero = torch.zeros((), dtype=points.dtype, device=dev)
    out_points = torch.where(out_valid[:, None], points[idx], zero)
    out_attrs = None
    if attrs is not None:
        taken = attrs[idx]
        mask = out_valid.reshape((m,) + (1,) * (taken.dim() - 1))
        out_attrs = torch.where(mask, taken, torch.zeros(
            (), dtype=taken.dtype, device=dev))
    return out_points, out_attrs, out_valid



def stratified_indices(valid: torch.Tensor, m: int):
    """Row indices + validity of the stratified subsample: the j-th output
    is the ⌊j·n_valid/m⌋-th valid row (identity + mask when n_valid ≤ m).
    Returns (idx (m,) int64, out_valid (m,) bool). The rank lookup is one
    ``searchsorted(side="left")`` at every n: the JAX package's tiered
    blocked search for n ≥ 2¹⁸ is a TPU workaround with identical results."""
    n = valid.shape[0]
    dev = valid.device
    rank = torch.cumsum(valid.to(torch.int32), 0, dtype=torch.int32)
    n_valid = rank[-1]
    j = torch.arange(m, dtype=torch.int32, device=dev)
    # j·(n_valid/m) in fp32 — NOT (j·n_valid)/m — then repaired to be
    # strictly increasing: t_j − j is nondecreasing in exact math, so a
    # running max undoes any ±1 fp32 floor misround.
    stride = div(n_valid.to(torch.float32), float(m))
    t = torch.floor(j.to(torch.float32) * stride).to(torch.int32) + 1
    u = torch.cummax(t - j, 0).values
    t = torch.minimum(u + j, n_valid.clamp_min(1))
    targets = torch.where(n_valid > m, t, j + 1)
    idx = torch.searchsorted(rank, targets, side="left").clamp_max(n - 1)
    out_valid = j < torch.minimum(n_valid, torch.full((), m, dtype=torch.int32,
                                                      device=dev))
    return idx, out_valid


def stratified_subsample(points: torch.Tensor, m: int,
                         valid: torch.Tensor | None = None,
                         attrs: torch.Tensor | None = None):
    """Every ⌈n_valid/m⌉-th valid point, compacted to ``m`` static slots.
    Returns ``(out_points (m,3), out_attrs or None, out_valid (m,))``."""
    if valid is None:
        valid = torch.ones(points.shape[0], dtype=torch.bool,
                           device=points.device)
    idx, out_valid = stratified_indices(valid, m)
    zero = torch.zeros((), dtype=points.dtype, device=points.device)
    out_points = torch.where(out_valid[:, None], points[idx], zero)
    out_attrs = None
    if attrs is not None:
        taken = attrs[idx]
        mask = out_valid.reshape((m,) + (1,) * (taken.dim() - 1))
        out_attrs = torch.where(mask, taken, torch.zeros((), dtype=taken.dtype,
                                                         device=taken.device))
    return out_points, out_attrs, out_valid


# ---------------------------------------------------------------------------
# Normals: analytic 3×3 symmetric eigensolver
# ---------------------------------------------------------------------------


def _det3(B: torch.Tensor) -> torch.Tensor:
    return (B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2]
                            - B[..., 1, 2] * B[..., 2, 1])
            - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2]
                              - B[..., 1, 2] * B[..., 2, 0])
            + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1]
                              - B[..., 1, 1] * B[..., 2, 0]))


def smallest_eigenvector_sym3(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., 3, 3).

    Trigonometric eigenvalue solve (no iteration, no LAPACK), then the
    eigenvector as the strongest column of (A − λ₁I)(A − λ₂I), whose columns
    all lie in the smallest eigenspace by Cayley–Hamilton. Degenerate
    (isotropic) inputs fall back to ẑ."""
    A = A.to(torch.float32)
    dev = A.device
    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 3.0
    eye = torch.eye(3, dtype=A.dtype, device=dev)
    B = A - q[..., None, None] * eye
    p2 = (B * B).sum(dim=(-2, -1)) / 6.0
    p = torch.sqrt(p2.clamp_min(0.0))
    safe_p = torch.where(p > 1e-20, p, torch.ones((), device=dev))
    r = (_det3(B / safe_p[..., None, None]) / 2.0).clamp(-1.0, 1.0)
    phi = torch.acos(r) / 3.0
    lam1 = q + 2.0 * p * torch.cos(phi)                        # largest
    lam3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    lam2 = 3.0 * q - lam1 - lam3
    M = (A - lam1[..., None, None] * eye) @ (A - lam2[..., None, None] * eye)
    norms = torch.linalg.norm(M, dim=-2)                       # column norms
    best = torch.argmax(norms, dim=-1)
    v = torch.gather(M, -1, best[..., None, None].expand(
        M.shape[:-1] + (1,)))[..., 0]
    vn = torch.linalg.norm(v, dim=-1, keepdim=True)
    degenerate = (vn[..., 0] < 1e-20) | (p < 1e-20)
    fallback = torch.tensor([0.0, 0.0, 1.0], dtype=A.dtype,
                            device=dev).expand(v.shape)
    return torch.where(degenerate[..., None], fallback,
                       v / torch.where(vn > 1e-20, vn,
                                       torch.ones((), device=dev)))


def estimate_normals(points: torch.Tensor, valid: torch.Tensor | None = None,
                     k: int = 30, neighbor_method: str = "auto",
                     neighbors=None):
    """Per-point unit normals from the k-NN covariance (PCA). Returns
    (normals (N,3), normal_valid (N,)); the sign is arbitrary.
    ``neighbors`` optionally supplies a precomputed ``(d2, idx, nb_valid)``
    self-query sweep (ascending, ≥ k columns, self included)."""
    n = points.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=points.device)
    pts = points.to(torch.float32)
    if neighbors is not None:
        check_neighbors(neighbors, n, k)
        _, idx, nbv = (a[:, :k] for a in neighbors)
        # The sweep may have been built under a wider validity mask.
        nbv = nbv & valid[idx]
    else:
        _, idx, nbv = _self_knn(pts, k, valid, False, neighbor_method)
    nbr = pts[idx]                                     # (N, k, 3)
    w = nbv.to(torch.float32)[..., None]
    cnt = w.sum(1).clamp_min(1.0)                      # (N, 1)
    mu = (nbr * w).sum(1) / cnt
    xc = (nbr - mu[:, None, :]) * w
    C = torch.einsum("nki,nkj->nij", xc, xc) / cnt[..., None]
    normals = smallest_eigenvector_sym3(C)
    nvalid = valid & (nbv.sum(1) >= 3)
    return normals, nvalid


def orient_normals(points: torch.Tensor, normals: torch.Tensor,
                   location: torch.Tensor, outward: bool = False):
    """Flip normals to point toward ``location`` (camera convention,
    `server/processing.py:273`) or away from it (``outward=True`` — the
    reference's radial trick of orienting at the cloud centre then
    negating, `server/processing.py:274-276`)."""
    to_loc = location[None, :] - points
    dots = (normals * to_loc).sum(-1, keepdim=True)
    flip = torch.logical_xor(dots < 0.0, torch.tensor(outward,
                                                      device=dots.device))
    return torch.where(flip, -normals, normals)
