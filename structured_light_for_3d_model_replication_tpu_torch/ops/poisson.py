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

With k ≥ 2 members (``reconstruct(members=…)``,
``mesh_from_cloud(device_mesh=…)``) every field of the solve is a
:class:`Slabs`: the grid cut along its first axis into
``parallel/mesh.blocks(R, k)`` planes, one slab a member of the space axis.
Each member splats the points whose trilinear corners reach its planes, and
takes its neighbours' edge planes (the halos) for the divergence and the
Laplacian, so those rows equal the whole grid's bit for bit; the sums over
the grid (the screen's density mean, the CG's dot products) are per-member
partials folded in member order on the first member, whose 0-d scalars go
back to the members. χ and the density are gathered where the points lie,
and the iso level is taken there from the whole grid. One device (no
members, or one) keeps its fields as plain tensors (:class:`_Whole`): the
same CG body, the one-card operations with nothing around them.
"""

from __future__ import annotations

import operator
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


def _cells(grid_pts: torch.Tensor, resolution: int):
    """Clamped grid coordinates and their lower corner cell (N,3) int64."""
    g = grid_pts.clamp(0.0, resolution - 1 - 1e-4)
    return g, torch.floor(g).to(torch.int64)


def _corner_weights(grid_pts: torch.Tensor, resolution: int):
    """Trilinear corner indices + weights: (flat (N,8) int64 into R³,
    w (N,8) float32)."""
    R = resolution
    g, i0 = _cells(grid_pts, R)
    f = g - i0.to(torch.float32)
    corners = torch.tensor(_CORNER_OFFS, dtype=torch.int64,
                           device=grid_pts.device)
    idx = (i0[:, None, :] + corners[None]).clamp(0, R - 1)
    flat = (idx[..., 0] * R + idx[..., 1]) * R + idx[..., 2]
    cf = corners[None].to(torch.float32)
    t = cf * f[:, None, :] + (1 - cf) * (1 - f[:, None, :])
    return flat, t[..., 0] * t[..., 1] * t[..., 2]


def splat(grid_pts: torch.Tensor, values: torch.Tensor, valid: torch.Tensor,
          resolution: int, planes: tuple[int, int] | None = None
          ) -> torch.Tensor:
    """Trilinear scatter-add of per-point values (N,C) → (R,R,R,C).
    ``planes`` = (s, e) keeps the corners on first-axis planes s…e-1 and
    returns those rows (e-s,R,R,C): each voxel gets the same terms in the
    same order as in the whole grid."""
    R = resolution
    c = values.shape[-1]
    flat, w = _corner_weights(grid_pts, R)
    w = w * valid.to(torch.float32)[:, None]
    contrib = w[..., None] * values[:, None, :]
    flat, contrib = flat.reshape(-1), contrib.reshape(-1, c)
    s, e = (0, R) if planes is None else planes
    if planes is not None:
        keep = (flat >= s * R * R) & (flat < e * R * R)
        flat, contrib = flat[keep] - s * R * R, contrib[keep]
    out = scatter_sum((e - s) * R * R, flat, contrib)
    return out.reshape(e - s, R, R, c)


def gather(grid: torch.Tensor, grid_pts: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation of a (R,R,R) field at (N,3) grid coords."""
    flat, w = _corner_weights(grid_pts, grid.shape[0])
    return (grid.reshape(-1)[flat] * w).sum(-1)


def _shift(x: torch.Tensor, axis: int, delta: int,
           halo: torch.Tensor | None = None) -> torch.Tensor:
    """Shift with edge clamp (Neumann boundary): x[i] ← x[i+delta]. The
    plane read past the edge is ``halo`` (a neighbouring slab's, one plane
    thick) where given, else the edge plane itself."""
    n = x.shape[axis]
    if delta == 1:
        edge = x.narrow(axis, n - 1, 1) if halo is None else halo
        return torch.cat([x.narrow(axis, 1, n - 1), edge], axis)
    edge = x.narrow(axis, 0, 1) if halo is None else halo
    return torch.cat([edge, x.narrow(axis, 0, n - 1)], axis)


def laplacian(x: torch.Tensor, lo: torch.Tensor | None = None,
              hi: torch.Tensor | None = None) -> torch.Tensor:
    """7-point Laplacian with Neumann (zero-flux) boundaries. ``lo`` /
    ``hi`` are the planes just below / above ``x`` along the first axis
    when ``x`` is a slab of a larger grid (None: a face of the grid)."""
    acc = -6.0 * x
    for axis in range(3):
        acc = (acc + _shift(x, axis, 1, hi if axis == 0 else None)
               + _shift(x, axis, -1, lo if axis == 0 else None))
    return acc


def divergence(V: torch.Tensor, lo: torch.Tensor | None = None,
               hi: torch.Tensor | None = None) -> torch.Tensor:
    """Central-difference divergence of a (R,R,R,3) vector grid. ``lo`` /
    ``hi`` are the first component's planes just below / above ``V``
    along the first axis when ``V`` is a slab (None: a face of the grid)."""
    out = torch.zeros(V.shape[:3], dtype=torch.float32, device=V.device)
    for axis in range(3):
        c = V[..., axis]
        out = out + 0.5 * (_shift(c, axis, 1, hi if axis == 0 else None)
                           - _shift(c, axis, -1, lo if axis == 0 else None))
    return out


def _density_mean(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    return total / count.clamp_min(1.0)


def screen_weights(density: torch.Tensor, screen,
                   wmean: torch.Tensor | None = None) -> torch.Tensor:
    """Normalised-density screen ``screen · density / mean(nonzero)`` — the
    one normalisation that the dense solve, the band solve's fine screen and
    the two-level preconditioner's coarse operator must share. ``wmean``
    is the nonzero mean when ``density`` is a slab of the grid it was
    taken over."""
    if wmean is None:
        wmean = _density_mean(density.sum(),
                              (density > 0).to(torch.float32).sum())
    return screen * density / wmean.clamp_min(1e-12)


class Slabs:
    """A grid field cut along its first axis: ``parts[j]`` holds planes
    ``planes[j]`` = (s, e) on ``devices[j]``, in member order (a member
    that owns no plane holds no part). Arithmetic runs part by part on
    each part's device; a 0-d tensor operand (a CG scalar, on the first
    member) is copied to each part's device."""

    def __init__(self, devices, planes, resolution: int, parts=()):
        self.devices, self.planes = list(devices), list(planes)
        self.R, self.parts = resolution, list(parts)

    @classmethod
    def cut(cls, members, resolution: int) -> "Slabs":
        """The layout, with no part yet, of ``members``' planes
        (``parallel/mesh.blocks``). A member may be listed more than once:
        members stepped in turn on one device."""
        from ..parallel.mesh import blocks

        kept = [(torch.device(d), p) for d, p in
                zip(members, blocks(resolution, len(members))) if p[1] > p[0]]
        return cls([d for d, _ in kept], [p for _, p in kept], resolution)

    def like(self, parts) -> "Slabs":
        return Slabs(self.devices, self.planes, self.R, parts)

    def split(self, x: torch.Tensor) -> "Slabs":
        """``x`` (R, R, R) as these planes on these devices."""
        return self.like([x[s:e].to(device=d, dtype=torch.float32)
                          for d, (s, e) in zip(self.devices, self.planes)])

    def zeros(self) -> "Slabs":
        return self.like([torch.zeros((e - s, self.R, self.R),
                                      dtype=torch.float32, device=d)
                          for d, (s, e) in zip(self.devices, self.planes)])

    def splat(self, grid_pts, values, valid) -> "Slabs":
        """:func:`splat` over each part's planes, on its device, of the
        points (in their order) whose lower corner plane is s-1…e-1: those
        with a corner on the part's planes."""
        i0 = _cells(grid_pts, self.R)[1][:, 0]
        out = []
        for d, (s, e) in zip(self.devices, self.planes):
            sel = (i0 >= s - 1) & (i0 < e)
            out.append(splat(grid_pts[sel].to(d), values[sel].to(d),
                             valid[sel].to(d), self.R, (s, e)))
        return self.like(out)

    def map(self, fn) -> "Slabs":
        return self.like([fn(p) for p in self.parts])

    def halos(self, fn=lambda p: p):
        """Per part, ``fn`` of the plane below and of the plane above it
        on the neighbouring parts, copied to the part's device (None at a
        face of the grid)."""
        n, p, d = len(self.parts), self.parts, self.devices
        return [(None if j == 0 else fn(p[j - 1][-1:]).to(d[j]),
                 None if j == n - 1 else fn(p[j + 1][:1]).to(d[j]))
                for j in range(n)]

    def halo_bytes(self) -> int:
        """Bytes one halo exchange of a float32 field copies."""
        return 2 * (len(self.planes) - 1) * self.R * self.R * 4

    def divergence(self) -> "Slabs":
        return self.like([divergence(v, lo, hi) for v, (lo, hi) in zip(
            self.parts, self.halos(lambda p: p[..., 0]))])

    def laplacian(self) -> "Slabs":
        return self.like([laplacian(x, lo, hi)
                          for x, (lo, hi) in zip(self.parts, self.halos())])

    def _fold(self, partials) -> torch.Tensor:
        """Partials summed in member order on the first member."""
        total = partials[0]
        for q in partials[1:]:
            total = total + q.to(self.devices[0])
        return total

    def dot(self, other: "Slabs") -> torch.Tensor:
        """Σ a·b over the grid, as a 0-d float32 tensor on the first
        member."""
        return self._fold([vdot(a, b)
                           for a, b in zip(self.parts, other.parts)])

    def screen(self, screen) -> "Slabs":
        """:func:`screen_weights` of this density over the whole grid."""
        wmean = _density_mean(
            self._fold([d.sum() for d in self.parts]),
            self._fold([(d > 0).to(torch.float32).sum()
                        for d in self.parts]))
        return self.like([screen_weights(p, screen, wmean.to(d))
                          for p, d in zip(self.parts, self.devices)])

    def gather(self, device) -> torch.Tensor:
        """The whole grid on ``device`` (``parallel/mesh.gather_rows``)."""
        from ..parallel.mesh import gather_rows

        return gather_rows(self.parts, 0, device)

    def _op(self, other, fn) -> "Slabs":
        if isinstance(other, Slabs):
            return self.like([fn(a, b)
                              for a, b in zip(self.parts, other.parts)])
        return self.like([fn(a, other.to(d))
                          for a, d in zip(self.parts, self.devices)])

    def __add__(self, o):
        return self._op(o, operator.add)

    def __sub__(self, o):
        return self._op(o, operator.sub)

    def __mul__(self, o):
        return self._op(o, operator.mul)

    __rmul__ = __mul__     # a float32 product does not depend on the order

    def __neg__(self):
        return self.map(operator.neg)


class _Whole:
    """The layout of a grid held whole on one device: its fields are plain
    (R, R, R) tensors and every step is the one-card operation itself.
    The field operations have :class:`Slabs`' names and take the field
    first, as ``Slabs``' methods called on the class do."""

    def __init__(self, device, resolution: int):
        self.device, self.R = torch.device(device), resolution

    def splat(self, grid_pts, values, valid) -> torch.Tensor:
        d = self.device
        return splat(grid_pts.to(d), values.to(d), valid.to(d), self.R)

    def zeros(self) -> torch.Tensor:
        return torch.zeros((self.R,) * 3, dtype=torch.float32,
                           device=self.device)

    def split(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(device=self.device, dtype=torch.float32)

    @staticmethod
    def map(x, fn):
        return fn(x)

    @staticmethod
    def gather(x, device) -> torch.Tensor:
        return x.to(device)

    divergence = staticmethod(divergence)
    laplacian = staticmethod(laplacian)
    dot = staticmethod(vdot)
    screen = staticmethod(screen_weights)


def _solve(points, normals, valid, resolution: int, cg_iters: int,
           screen: float, rtol: float = 3e-4, x0=None, members=None):
    """Splat, divergence, Jacobi-PCG from ``x0`` (None = a cold start from
    zeros), iso, over ``members``' slabs (None: the points' device alone).
    The CG's scalars live on the first member; the host reads its stop
    once an iteration. Returns (PoissonGrid on the points' device,
    iterations used)."""
    R = resolution
    dev = points.device
    grid_pts, origin, scale = normalize_points(points, valid, R)
    if members is None or len(members) == 1:
        lay = _Whole(dev if members is None else members[0], R)
    else:
        lay = Slabs.cut(members, R)
    F = type(lay)       # the field operations, field first
    vw = lay.splat(grid_pts, torch.cat(
        [normals, torch.ones((points.shape[0], 1), device=dev)], -1), valid)
    V = F.map(vw, lambda t: t[..., :3])
    density = F.map(vw, lambda t: t[..., 3].contiguous())
    rhs = F.divergence(V)
    del vw, V
    W = F.screen(density, screen)

    def matvec(x):
        return -(F.laplacian(x) - W * x)

    b = -rhs
    x = lay.zeros() if x0 is None else lay.split(x0)
    dinv = F.map(W, lambda w: 1.0 / (6.0 + w))
    r = b - matvec(x)
    p = dinv * r
    rz = F.dot(r, p)
    rt = torch.tensor(rtol, dtype=torch.float32, device=rz.device)
    tol2 = rt * rt * F.dot(b, b)
    rs = F.dot(r, r)
    it = 0
    while it < cg_iters and bool(rs > tol2):
        Ap = matvec(p)
        alpha = rz / F.dot(p, Ap).clamp_min(1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = dinv * r
        rz_new = F.dot(r, z)
        beta = rz_new / rz.clamp_min(1e-30)
        p = z + beta * p
        rz, rs, it = rz_new, F.dot(r, r), it + 1

    x, density = F.gather(x, dev), F.gather(density, dev)
    chi_at_pts = gather(x, grid_pts)
    wpts = valid.to(torch.float32) * gather(density, grid_pts)
    iso = (chi_at_pts * wpts).sum() / wpts.sum().clamp_min(1.0)
    return PoissonGrid(x, density, iso, origin, scale), it


def reconstruct(points: torch.Tensor, normals: torch.Tensor,
                valid: torch.Tensor | None = None, depth: int = 6,
                cg_iters: int = 300, screen: float = 4.0,
                rtol: float = 3e-4, x0=None,
                return_iters: bool = False, members=None) -> PoissonGrid:
    """Screened-Poisson solve on a 2^depth dense grid, on the device the
    points lie on. ``depth`` > 8 is rejected (the band-sparse solver covers
    it). ``cg_iters`` caps the PCG; the residual stop (``rtol``) usually
    ends it sooner. ``x0`` warm-starts the CG from a previous solve's χ
    grid (R, R, R) — the streaming previewer threads its last preview
    through, and the residual stop then fires after far fewer iterations.
    ``return_iters`` also returns the iteration count. ``members`` (a
    mesh's space members, in order) cuts the grid into their slabs of
    planes and solves each on its member (:class:`Slabs`); the grid comes
    back on the points' device. A member that cannot be reached raises:
    the solve never falls back to one device."""
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
                         x0=x0, members=members)
    return (grid, iters) if return_iters else grid
