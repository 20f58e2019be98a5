"""Sparse brick-grid TSDF integration on the device, in place (counterpart of
the JAX ``ops/tsdf.py``).

The volume is a virtual ``2^grid_depth`` cube of voxels stored as flat 8³
bricks, (cap, 512), in a fixed-capacity pool addressed through a DENSE brick
directory ((NB³,) int32 slot map, NB = 2^grid_depth / 8): allocation is a
prefix sum over the newly touched directory cells, never a host hash table.

Sign convention: positive = inside (behind the observed surface), as the
Poisson χ, so the marching extractors' ``inside = value > iso`` logic
(iso = 0) carries over. Each valid point updates the (2·splat_radius+1)³
voxel window around it with the projective point-to-plane distance
``dot(voxel_center − p, d̂)`` along the per-point INWARD unit direction d̂
(the viewing ray for streaming stops, :func:`camera_dirs`; −n̂ for oriented
clouds), clamped to ±1 truncation unit; weights taper linearly to the band
edge; TSDF, weight and RGB fold in by weighted running average with the
weight clamp (:mod:`.tsdf_combine` — the CUDA kernel ``csrc/combine.cu`` on
the card). Optional free-space carving decays the weight of observed-empty
voxels toward the camera.

The JAX package donates the volume buffers to one jitted program; here the
volume's own tensors are updated in place on the card (the combine writes
into them) and the returned :class:`TSDFState` holds the new tensors.
Scatters that the JAX package drops past the end (``mode="drop"``) write
into one spare row that is cut off. The stop's weighted sums are one
scatter (:func:`._scatter.scatter_sum`); on the card it sorts, so the sums
are the same from run to run. :func:`integrate_oracle` is the NumPy oracle
(dense grid, same float32 formulas), copied from the JAX package.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .._device import div
from ._scatter import scatter_sum

BS = 8
V = BS ** 3                  # 512 voxels per brick


class TSDFParams(NamedTuple):
    """Fixed configuration of a TSDF volume (the JAX package's fields and
    defaults)."""

    grid_depth: int = 8          # virtual cube = 2^grid_depth voxels/axis
    max_bricks: int = 8192       # fixed brick-pool capacity
    splat_radius: int = 1        # update window = (2r+1)³ voxels per point
    trunc_voxels: float = 3.0    # truncation distance in voxels
    max_weight: float = 64.0     # running-average weight clamp
    # Free-space carving (0 = off): ``carve_steps`` one-voxel samples from
    # the truncation-band edge toward the camera decay the weight of
    # already-allocated voxels by exp(-carve_weight) per hit; a voxel under
    # 1e-3 weight resets to unobserved.
    carve_steps: int = 0
    carve_weight: float = 0.25

    @property
    def resolution(self) -> int:
        return 1 << int(self.grid_depth)

    @property
    def nb(self) -> int:
        return self.resolution // BS


class TSDFState(NamedTuple):
    """Volume tensors on one device (shapes fixed by TSDFParams). ``tsdf``
    is in truncation units, positive inside; unobserved voxels hold −1 and
    weight 0."""

    dir_map: torch.Tensor       # (NB³,) int32 brick slot, −1 = inactive
    tsdf: torch.Tensor          # (cap, 512) float32
    weight: torch.Tensor        # (cap, 512) float32 accumulated weight
    rgb: torch.Tensor           # (cap, 512, 3) float32 running mean colour
    brick_coords: torch.Tensor  # (cap, 3) int32 brick coords of each slot
    n_bricks: torch.Tensor      # () int32 active slots


def init_state(params: TSDFParams, device) -> TSDFState:
    cap = int(params.max_bricks)
    dev = torch.device(device)
    return TSDFState(
        dir_map=torch.full((params.nb ** 3,), -1, dtype=torch.int32,
                           device=dev),
        tsdf=torch.full((cap, V), -1.0, dtype=torch.float32, device=dev),
        weight=torch.zeros((cap, V), dtype=torch.float32, device=dev),
        rgb=torch.zeros((cap, V, 3), dtype=torch.float32, device=dev),
        brick_coords=torch.zeros((cap, 3), dtype=torch.int32, device=dev),
        n_bricks=torch.zeros((), dtype=torch.int32, device=dev))


@functools.lru_cache(maxsize=None)
def _window_offsets(radius: int) -> np.ndarray:
    r = int(radius)
    g = np.mgrid[-r:r + 1, -r:r + 1, -r:r + 1]
    return g.reshape(3, -1).T.astype(np.int32)        # ((2r+1)³, 3)


def _combine(state: TSDFState, num, den, rgbnum, max_weight: float):
    """Weighted running-average fold: the kernel wrapper, writing into the
    volume's own tensors on the card; new tensors from the plain version on
    the host."""
    from .tsdf_combine import tsdf_combine

    return tsdf_combine(state.tsdf, state.weight, state.rgb, num, den,
                        rgbnum, max_weight,
                        out=(state.tsdf, state.weight, state.rgb))


def _flat_voxel(vox: torch.Tensor, ok: torch.Tensor, dir_map: torch.Tensor,
                nb: int, cap: int) -> torch.Tensor:
    """(…, 3) int32 voxel coords → flat (slot · 512 + intra) pool index,
    ``cap · 512`` (the spare row) where not ``ok`` or not allocated."""
    bc = vox >> 3
    cell = (bc[..., 0] * nb + bc[..., 1]) * nb + bc[..., 2]
    slot = dir_map[torch.where(ok, cell, 0).long()]
    intra = ((vox[..., 0] & 7) * BS + (vox[..., 1] & 7)) * BS \
        + (vox[..., 2] & 7)
    flat = slot.long() * V + intra.long()
    return torch.where(ok & (slot >= 0), flat, cap * V)


def integrate(state: TSDFState, params: TSDFParams, points, colors, valid,
              dirs, origin, voxel_size: float):
    """Fuse one stop (world-frame tensors on the volume's device) into the
    volume.

    ``points`` (P, 3) float32, ``colors`` (P, 3) float32 (0–255), ``valid``
    (P,) bool, ``dirs`` (P, 3) float32 unit INWARD directions
    (:func:`camera_dirs` / ``−normals``), ``origin`` (3,), ``voxel_size`` a
    float. Returns ``(state, n_wanted)`` — ``n_wanted > max_bricks`` means
    the pool overflowed and the excess bricks were dropped (holes, never an
    error). The passed-in state's tensors are updated in place where the
    card allows and must not be reused."""
    dev = state.tsdf.device
    depth = int(params.grid_depth)
    cap = int(params.max_bricks)
    r_vox = 1 << depth
    nb = r_vox // BS
    nb3 = nb ** 3
    f32 = torch.float32
    points = torch.as_tensor(points, dtype=f32, device=dev)
    colors = torch.as_tensor(colors, dtype=f32, device=dev)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    dirs = torch.as_tensor(dirs, dtype=f32, device=dev)
    origin = torch.as_tensor(origin, dtype=f32, device=dev)
    offs = torch.from_numpy(_window_offsets(params.splat_radius)).to(dev)
    dir_map, coords, n_bricks = (state.dir_map, state.brick_coords,
                                 state.n_bricks)

    # -- per-point voxel window + projective TSDF samples ------------------
    g = div(points - origin[None, :], float(voxel_size))      # (P, 3) grid
    v0 = torch.floor(g).to(torch.int32)
    vox = v0[:, None, :] + offs[None, :, :]                   # (P, K, 3)
    inb = ((vox >= 0) & (vox < r_vox)).all(-1)
    ok = valid[:, None] & inb
    d = (vox.to(f32) + 0.5 - g[:, None, :]) * dirs[:, None, :]
    sdf = d[..., 0] + d[..., 1] + d[..., 2]                   # voxel units
    u = div(sdf, float(params.trunc_voxels)).clamp(-1.0, 1.0)
    zero = torch.zeros((), dtype=f32, device=dev)
    w = torch.where(ok, (1.0 - u.abs()).clamp_min(0.0), zero)
    ok = ok & (w > 0.0)

    # -- allocate newly touched bricks (prefix sum) ------------------------
    bc = vox >> 3
    cell = (bc[..., 0] * nb + bc[..., 1]) * nb + bc[..., 2]
    cell_s = torch.where(ok, cell, nb3).long().reshape(-1)
    touched = torch.zeros(nb3 + 1, dtype=torch.bool, device=dev)
    touched[cell_s] = True
    new = touched[:nb3] & (dir_map < 0)
    rank = torch.cumsum(new.to(torch.int32), 0, dtype=torch.int32) - 1
    slot = n_bricks + rank
    alloc_ok = new & (slot < cap)
    dir_map = torch.where(alloc_ok, slot, dir_map)
    n_wanted = n_bricks + new.sum(dtype=torch.int32)
    cid = torch.arange(nb3, dtype=torch.int32, device=dev)
    bxyz = torch.stack([cid // (nb * nb), (cid // nb) % nb, cid % nb], 1)
    dest = torch.where(alloc_ok, slot, cap).long()
    coords = torch.cat([coords, coords.new_zeros((1, 3))])
    coords[dest] = bxyz
    coords = coords[:cap]

    # -- scatter the stop's weighted sums into the brick pool --------------
    flat = _flat_voxel(vox, ok, dir_map, nb, cap).reshape(-1)
    sums = scatter_sum(cap * V + 1, flat, torch.cat(
        [(w * u)[..., None], w[..., None], w[..., None] * colors[:, None, :]],
        -1).reshape(-1, 5))[:cap * V].reshape(cap, V, 5)
    num, den, rgbnum = (sums[..., 0].contiguous(),
                        sums[..., 1].contiguous(),
                        sums[..., 2:].contiguous())
    del flat, w, u, d, vox, sums
    tsdf, weight, rgb = _combine(state, num, den, rgbnum,
                                 float(params.max_weight))
    del num, den, rgbnum

    if params.carve_steps:
        # Free-space carving: samples marching from one voxel past the
        # truncation band toward the camera are observed EMPTY; decay their
        # weight (only already-allocated bricks; absent slots drop).
        qs = float(params.trunc_voxels) + torch.arange(
            1, int(params.carve_steps) + 1, dtype=f32, device=dev)
        samp = g[:, None, :] - dirs[:, None, :] * qs[None, :, None]
        cvox = torch.floor(samp).to(torch.int32)
        cok = valid[:, None] & ((cvox >= 0) & (cvox < r_vox)).all(-1)
        cflat = _flat_voxel(cvox, cok, dir_map, nb, cap).reshape(-1)
        hits = torch.zeros(cap * V + 1, dtype=f32, device=dev).index_add_(
            0, cflat, torch.ones(cflat.shape, dtype=f32, device=dev))[
            :cap * V].reshape(cap, V)
        new_w = weight * torch.exp(-float(params.carve_weight) * hits)
        erased = (hits > 0.0) & (new_w < 1e-3)
        tsdf = torch.where(erased, torch.full((), -1.0, device=dev), tsdf)
        weight = torch.where(erased, zero, new_w)

    out = TSDFState(dir_map, tsdf, weight, rgb, coords,
                    torch.minimum(n_wanted, torch.full(
                        (), cap, dtype=torch.int32, device=dev)))
    return out, n_wanted


def camera_dirs(points: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """Unit inward directions for a streaming stop: along the viewing ray,
    away from the camera centre ``cam`` (3,); degenerate points at the
    camera get the +z axis."""
    d = points - cam[None, :]
    n = torch.linalg.norm(d, dim=-1, keepdim=True)
    axis = torch.tensor([0.0, 0.0, 1.0], dtype=points.dtype,
                        device=points.device)
    return torch.where(n > 1e-9, d / n.clamp_min(1e-9), axis)


def neighbor_table(state: TSDFState, params: TSDFParams):
    """(nbr (cap, 6) int32, block_valid (cap,) bool) for the marching
    extractors: face-neighbour slots through the dense directory, columns
    +x, −x, +y, −y, +z, −z; absent, out of the grid or past ``n_bricks`` =
    cap."""
    cap = int(params.max_bricks)
    nb = params.nb
    dev = state.tsdf.device
    dirs6 = torch.tensor([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                          [0, 0, 1], [0, 0, -1]], dtype=torch.int32,
                         device=dev)
    row_ok = torch.arange(cap, dtype=torch.int32, device=dev) \
        < state.n_bricks
    nbc = state.brick_coords[:, None, :] + dirs6[None, :, :]   # (cap, 6, 3)
    inb = ((nbc >= 0) & (nbc < nb)).all(-1)
    cell = (nbc[..., 0] * nb + nbc[..., 1]) * nb + nbc[..., 2]
    slot = state.dir_map[torch.where(inb, cell, 0).long()]
    nbr = torch.where(inb & (slot >= 0) & row_ok[:, None], slot, cap)
    nbr = torch.where(nbr < state.n_bricks, nbr, cap)
    return nbr.to(torch.int32), row_ok


# ---------------------------------------------------------------------------
# NumPy oracle (dense grid, same float32 formulas; copied from the JAX
# package)
# ---------------------------------------------------------------------------


def integrate_oracle(dense, points, colors, valid, dirs, origin,
                     voxel_size, params: TSDFParams):
    """Dense-grid NumPy reference for :func:`integrate`. ``dense`` is None
    (fresh volume) or a previous call's ``(tsdf, weight, rgb)`` dense
    (R, R, R[, 3]) float32 arrays. Only the scatter-add ORDER differs from
    the device op (parity is allclose, not bitwise)."""
    r_vox = params.resolution
    if dense is None:
        tsdf = np.full((r_vox,) * 3, -1.0, np.float32)
        weight = np.zeros((r_vox,) * 3, np.float32)
        rgb = np.zeros((r_vox,) * 3 + (3,), np.float32)
    else:
        tsdf, weight, rgb = (a.copy() for a in dense)
    pts = np.asarray(points, np.float32)
    cols = np.asarray(colors, np.float32)
    val = np.asarray(valid, bool)
    dr = np.asarray(dirs, np.float32)
    origin = np.asarray(origin, np.float32)
    voxel = np.float32(voxel_size)
    trunc = np.float32(params.trunc_voxels)

    g = (pts - origin[None, :]) / voxel
    v0 = np.floor(g).astype(np.int64)
    num = np.zeros_like(tsdf)
    den = np.zeros_like(weight)
    rgbnum = np.zeros_like(rgb)
    for off in _window_offsets(params.splat_radius):
        vox = v0 + off[None, :]
        ok = val & np.all((vox >= 0) & (vox < r_vox), axis=-1)
        center = vox.astype(np.float32) + np.float32(0.5)
        sdf = np.sum((center - g) * dr, axis=-1, dtype=np.float32)
        u = np.clip(sdf / trunc, -1.0, 1.0).astype(np.float32)
        w = np.where(ok, np.maximum(1.0 - np.abs(u), 0.0),
                     0.0).astype(np.float32)
        ok = ok & (w > 0.0)
        ix, iy, iz = (vox[ok, i] for i in range(3))
        np.add.at(num, (ix, iy, iz), w[ok] * u[ok])
        np.add.at(den, (ix, iy, iz), w[ok])
        np.add.at(rgbnum, (ix, iy, iz), w[ok, None] * cols[ok])

    wsum = weight + den
    safe = np.maximum(wsum, np.float32(1e-12))
    tsdf = np.where(den > 0.0, (tsdf * weight + num) / safe, tsdf)
    rgb = np.where((den > 0.0)[..., None],
                   (rgb * weight[..., None] + rgbnum) / safe[..., None], rgb)
    weight = np.minimum(wsum, np.float32(params.max_weight))

    if params.carve_steps:
        hits = np.zeros_like(weight)
        cw = np.float32(params.carve_weight)
        for q in range(1, int(params.carve_steps) + 1):
            samp = g - dr * np.float32(trunc + q)
            cvox = np.floor(samp).astype(np.int64)
            cok = val & np.all((cvox >= 0) & (cvox < r_vox), axis=-1)
            ix, iy, iz = (cvox[cok, i] for i in range(3))
            np.add.at(hits, (ix, iy, iz), np.float32(1.0))
        new_w = weight * np.exp(-cw * hits, dtype=np.float32)
        erased = (hits > 0.0) & (new_w < 1e-3)
        tsdf = np.where(erased, np.float32(-1.0), tsdf)
        weight = np.where(erased, np.float32(0.0),
                          new_w).astype(np.float32)

    return tsdf.astype(np.float32), weight.astype(np.float32), \
        rgb.astype(np.float32)


def state_to_dense(state: TSDFState, params: TSDFParams):
    """Brick-pool state → dense ``(tsdf, weight, rgb)`` host arrays (the
    oracle's layout)."""
    r_vox = params.resolution
    tsdf = np.full((r_vox,) * 3, -1.0, np.float32)
    weight = np.zeros((r_vox,) * 3, np.float32)
    rgb = np.zeros((r_vox,) * 3 + (3,), np.float32)
    n = int(state.n_bricks)
    coords = state.brick_coords[:n].cpu().numpy()
    t = state.tsdf[:n].cpu().numpy().reshape(n, BS, BS, BS)
    w = state.weight[:n].cpu().numpy().reshape(n, BS, BS, BS)
    c = state.rgb[:n].cpu().numpy().reshape(n, BS, BS, BS, 3)
    for i, (bx, by, bz) in enumerate(coords):
        sl = (slice(bx * BS, bx * BS + BS), slice(by * BS, by * BS + BS),
              slice(bz * BS, bz * BS + BS))
        tsdf[sl] = t[i]
        weight[sl] = w[i]
        rgb[sl] = c[i]
    return tsdf, weight, rgb
