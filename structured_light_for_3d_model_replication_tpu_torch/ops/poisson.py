"""Dense-grid screened-Poisson surface reconstruction (counterpart of the JAX
``ops/poisson.py``).

1. trilinear **splat** of the oriented normal field into a (R,R,R,3) vector
   grid V plus a scalar sample-density grid — one scatter-sum
   (:func:`._scatter.scatter_sum`: ``index_add_`` on the CPU, a sorting
   accumulate on the card, the same bits on every run);
2. **divergence** of V by central differences;
3. the screened Poisson equation ``(∇² − α·W)χ = ∇·V`` solved with
   Jacobi-preconditioned **conjugate gradients** (7-point Laplacian with
   Neumann boundaries, W the normalised splat-density screen);
4. the iso level as the density-weighted mean of χ at the samples.

It serves ``mesh_from_cloud`` at depth ≤ 8, the streaming session's coarse
previews, and is the coarse solve inside the band-sparse one
(:mod:`.poisson_sparse`). No kernel: every step is a handful of PyTorch
operations on the grid. The CG stops on the JAX package's rule
(``rs > rtol²·‖b‖²`` and the iteration cap), read on the host once per
iteration, so the iteration count matches. ``x0`` warm-starts the CG from a
previous χ grid at the solve resolution.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import div
from ._scatter import scatter_sum

_CORNER_OFFS = [[dx, dy, dz] for dx in (0, 1) for dy in (0, 1)
                for dz in (0, 1)]


class PoissonGrid(NamedTuple):
    """Result of the Poisson solve, everything needed for extraction."""

    chi: torch.Tensor      # (R, R, R) float32 implicit function
    density: torch.Tensor  # (R, R, R) float32 splat density (trim support)
    iso: torch.Tensor      # () float32 iso level at the surface
    origin: torch.Tensor   # (3,) float32 world position of voxel (0,0,0)
    scale: torch.Tensor    # () float32 world size of one voxel


def vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ a·b over every element, as a 0-d float32 tensor."""
    return torch.dot(a.reshape(-1), b.reshape(-1))


def normalize_points(points: torch.Tensor, valid: torch.Tensor,
                     resolution: int, pad_frac: float = 0.10):
    """Map points into grid coordinates [0, R-1] with a padded bounding cube.

    Returns (grid_pts (N,3), origin (3,), voxel_scale ()). The cube is
    isotropic (same scale on all axes) so normals keep their direction."""
    big = torch.full((), 1e30, dtype=torch.float32, device=points.device)
    v = valid[:, None]
    lo = torch.where(v, points, big).amin(0)
    hi = torch.where(v, points, -big).amax(0)
    extent = (hi - lo).amax()
    extent = torch.where(extent > 1e-12, extent, torch.ones_like(extent))
    pad = extent * pad_frac
    scale = div(extent + 2 * pad, float(resolution - 1))
    center = 0.5 * (lo + hi)
    origin = center - 0.5 * (extent + 2 * pad)
    grid_pts = (points - origin) / scale
    return grid_pts, origin, scale


def _corner_weights(grid_pts: torch.Tensor, resolution: int):
    """Trilinear corner indices + weights: (flat (N,8) int64 into R³,
    w (N,8) float32)."""
    R = resolution
    g = grid_pts.clamp(0.0, R - 1 - 1e-4)
    i0 = torch.floor(g).to(torch.int64)
    f = g - i0.to(torch.float32)
    corners = torch.tensor(_CORNER_OFFS, dtype=torch.int64,
                           device=grid_pts.device)
    idx = (i0[:, None, :] + corners[None]).clamp(0, R - 1)
    flat = (idx[..., 0] * R + idx[..., 1]) * R + idx[..., 2]
    cf = corners[None].to(torch.float32)
    t = cf * f[:, None, :] + (1 - cf) * (1 - f[:, None, :])
    return flat, t[..., 0] * t[..., 1] * t[..., 2]


def splat(grid_pts: torch.Tensor, values: torch.Tensor, valid: torch.Tensor,
          resolution: int) -> torch.Tensor:
    """Trilinear scatter-add of per-point values (N,C) → (R,R,R,C)."""
    R = resolution
    c = values.shape[-1]
    flat, w = _corner_weights(grid_pts, R)
    w = w * valid.to(torch.float32)[:, None]
    contrib = w[..., None] * values[:, None, :]
    out = scatter_sum(R * R * R, flat.reshape(-1), contrib.reshape(-1, c))
    return out.reshape(R, R, R, c)


def gather(grid: torch.Tensor, grid_pts: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation of a (R,R,R) field at (N,3) grid coords."""
    flat, w = _corner_weights(grid_pts, grid.shape[0])
    return (grid.reshape(-1)[flat] * w).sum(-1)


def _shift(x: torch.Tensor, axis: int, delta: int) -> torch.Tensor:
    """Shift with edge clamp (Neumann boundary): x[i] ← x[i+delta]."""
    n = x.shape[axis]
    if delta == 1:
        return torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)],
                         axis)
    return torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], axis)


def laplacian(x: torch.Tensor) -> torch.Tensor:
    """7-point Laplacian with Neumann (zero-flux) boundaries."""
    acc = -6.0 * x
    for axis in range(3):
        acc = acc + _shift(x, axis, 1) + _shift(x, axis, -1)
    return acc


def divergence(V: torch.Tensor) -> torch.Tensor:
    """Central-difference divergence of a (R,R,R,3) vector grid."""
    out = torch.zeros(V.shape[:3], dtype=torch.float32, device=V.device)
    for axis in range(3):
        c = V[..., axis]
        out = out + 0.5 * (_shift(c, axis, 1) - _shift(c, axis, -1))
    return out


def screen_weights(density: torch.Tensor, screen) -> torch.Tensor:
    """Normalised-density screen ``screen · density / mean(nonzero)`` — the
    one normalisation that the dense solve, the band solve's fine screen and
    the two-level preconditioner's coarse operator must share."""
    wmean = density.sum() / (density > 0).to(torch.float32).sum().clamp_min(
        1.0)
    return screen * density / wmean.clamp_min(1e-12)


def _solve(points, normals, valid, resolution: int, cg_iters: int,
           screen: float, rtol: float = 3e-4, x0=None):
    """Splat, divergence, Jacobi-PCG from ``x0`` (None = a cold start from
    zeros), iso. Returns (PoissonGrid, iterations used)."""
    R = resolution
    dev = points.device
    grid_pts, origin, scale = normalize_points(points, valid, R)
    vw = splat(grid_pts, torch.cat(
        [normals, torch.ones((points.shape[0], 1), device=dev)], -1),
        valid, R)
    V, density = vw[..., :3], vw[..., 3].contiguous()
    rhs = divergence(V)
    del vw, V
    W = screen_weights(density, screen)

    def matvec(x):
        return -(laplacian(x) - W * x)

    b = -rhs
    x = torch.zeros((R, R, R), dtype=torch.float32, device=dev) \
        if x0 is None else x0.to(device=dev, dtype=torch.float32)
    dinv = 1.0 / (6.0 + W)
    r = b - matvec(x)
    p = dinv * r
    rz = vdot(r, p)
    rt = torch.tensor(rtol, dtype=torch.float32, device=dev)
    tol2 = rt * rt * vdot(b, b)
    rs = vdot(r, r)
    it = 0
    while it < cg_iters and bool(rs > tol2):
        Ap = matvec(p)
        alpha = rz / vdot(p, Ap).clamp_min(1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = dinv * r
        rz_new = vdot(r, z)
        beta = rz_new / rz.clamp_min(1e-30)
        p = z + beta * p
        rz, rs, it = rz_new, vdot(r, r), it + 1

    chi_at_pts = gather(x, grid_pts)
    wpts = valid.to(torch.float32) * gather(density, grid_pts)
    iso = (chi_at_pts * wpts).sum() / wpts.sum().clamp_min(1.0)
    return PoissonGrid(x, density, iso, origin, scale), it


def reconstruct(points: torch.Tensor, normals: torch.Tensor,
                valid: torch.Tensor | None = None, depth: int = 6,
                cg_iters: int = 300, screen: float = 4.0,
                rtol: float = 3e-4, x0=None,
                return_iters: bool = False) -> PoissonGrid:
    """Screened-Poisson solve on a 2^depth dense grid, on the device the
    points lie on. ``depth`` > 8 is rejected (the band-sparse solver covers
    it). ``cg_iters`` caps the PCG; the residual stop (``rtol``) usually
    ends it sooner. ``x0`` warm-starts the CG from a previous solve's χ
    grid (R, R, R) — the streaming previewer threads its last preview
    through, and the residual stop then fires after far fewer iterations.
    ``return_iters`` also returns the iteration count."""
    if depth > 8:
        raise ValueError(
            f"depth={depth} > 8: dense-grid Poisson is capped at 256³ "
            "(the reference similarly guards depth > 16)")
    R = 2 ** depth
    if x0 is not None and tuple(getattr(x0, "shape", ())) != (R, R, R):
        raise ValueError(f"x0 shape {tuple(getattr(x0, 'shape', ()))} does "
                         f"not match the depth-{depth} grid ({R}³)")
    points = points.to(torch.float32)
    normals = normals.to(torch.float32)
    if valid is None:
        valid = torch.ones(points.shape[0], dtype=torch.bool,
                           device=points.device)
    grid, iters = _solve(points, normals, valid, R, cg_iters, screen, rtol,
                         x0=x0)
    return (grid, iters) if return_iters else grid
