"""Plane segmentation by RANSAC — background (wall) removal (counterpart of
the JAX ``ops/segmentation.py``).

Replaces Open3D ``segment_plane`` as the reference uses it to drop the
dominant plane (`server/processing.py:37-39`, `Old/blackground_remove.py:
10-16`): hypotheses of three sampled points, scored against every point in
batches of 256, the best count kept; then a least-squares refit on the
winning inlier set (the smallest principal direction of their scatter),
kept when it has at least as many inliers.

The hypotheses come from a ``torch.Generator`` (default seed 0), not the
JAX package's ``jax.random`` stream, so the two packages draw different
triples: outcomes compare, bits do not.
"""

from __future__ import annotations

import torch

from .pointcloud import smallest_eigenvector_sym3

_ROWS = 1 << 18   # points scored per block (bounds the (rows, 256) block)


def _plane_dist(pts: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """|p · n + d| of (N, 3) points against (H, 4) planes, (N, H)."""
    return (pts @ planes[:, :3].T + planes[:, 3]).abs()


def segment_plane(points: torch.Tensor, distance_threshold: float = 10.0,
                  num_iterations: int = 1000,
                  valid: torch.Tensor | None = None,
                  generator: torch.Generator | None = None):
    """Returns (plane (4,) [a, b, c, d] with ‖n‖ = 1, inlier_mask (N,)).
    ``remove_background`` keeps the complement of the inliers
    (`server/processing.py:42`)."""
    pts = points.to(torch.float32)
    n = pts.shape[0]
    dev = pts.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    vf = valid.to(torch.float32)
    batch = min(256, num_iterations)
    n_batches = max(1, num_iterations // batch)

    best = torch.tensor([0.0, 0.0, 1.0, 0.0], device=dev)
    best_cnt = torch.full((), -1.0, device=dev)
    for _ in range(n_batches):
        i = torch.randint(0, n, (batch, 3), generator=generator, device=dev)
        p0, p1, p2 = pts[i[:, 0]], pts[i[:, 1]], pts[i[:, 2]]
        nrm = torch.linalg.cross(p1 - p0, p2 - p0, dim=-1)
        ln = torch.linalg.norm(nrm, dim=-1)
        ok = (ln > 1e-12) & valid[i].all(1)
        nrm = nrm / torch.where(ln > 1e-12, ln, torch.ones((), device=dev)
                                )[:, None]
        planes = torch.cat([nrm, -(nrm * p0).sum(-1, keepdim=True)], 1)
        cnt = torch.zeros(batch, device=dev)
        for s in range(0, n, _ROWS):
            inl = _plane_dist(pts[s:s + _ROWS], planes) <= distance_threshold
            cnt += (inl.to(torch.float32) * vf[s:s + _ROWS, None]).sum(0)
        cnt = torch.where(ok, cnt, torch.full((), -1.0, device=dev))
        j = torch.argmax(cnt)
        better = cnt[j] > best_cnt
        best = torch.where(better, planes[j], best)
        best_cnt = torch.where(better, cnt[j], best_cnt)

    inl = (_plane_dist(pts, best[None])[:, 0] <= distance_threshold) & valid
    # Least-squares refit on the inliers (the polish Open3D applies).
    w = inl.to(torch.float32)[:, None]
    cnt = w.sum().clamp_min(1.0)
    mu = (pts * w).sum(0) / cnt
    xc = (pts - mu) * w
    nrm = smallest_eigenvector_sym3(xc.T @ xc / cnt)
    refit = torch.cat([nrm, -(nrm * mu).sum()[None]])
    refit_inl = (_plane_dist(pts, refit[None])[:, 0]
                 <= distance_threshold) & valid
    use_refit = refit_inl.sum() >= inl.sum()
    return (torch.where(use_refit, refit, best),
            torch.where(use_refit, refit_inl, inl))
