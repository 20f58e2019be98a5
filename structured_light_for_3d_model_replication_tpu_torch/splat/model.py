"""SplatScene: seed Gaussians on the TSDF iso-shell, render, save/load
(counterpart of the JAX ``splat/model.py``).

Seeding is one pass over the volume's active bricks (``ops/tsdf.py``
layout): voxels inside the truncation band (|tsdf| < ``iso_band``,
observed) are the shell candidates; a halo central difference over
face-neighbour bricks gives each its SDF gradient; the stratified compaction
(:func:`..ops.pointcloud.stratified_indices`) picks ``capacity`` of them.
Each splat lands ON the iso-surface (voxel centre − sdf·∇̂, the projective
snap), its disc frame comes from the gradient (outward normal = −∇̂), its DC
colour from the volume's fused RGB — so a scene renders the moment it is
seeded, before any appearance fit.

Every seeded tensor has ``capacity`` rows and a valid mask. A scene's npz
archive (:meth:`SplatScene.to_bytes`) is the JAX package's v1 schema, so
either package reads the other's scenes.
"""

from __future__ import annotations

import io as _io
import logging
import zlib
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import div, resolve_device
from ..fusion.volume import TSDFVolume
from ..ops import pointcloud
from ..ops import splat_render as sr
from ..ops import tsdf as tsdf_ops

log = logging.getLogger(__name__)

#: npz schema stamp for save/load (the JAX package's).
_SCENE_VERSION = 1


class SplatParams(NamedTuple):
    """Seeding/appearance knobs (the JAX package's fields and defaults)."""

    capacity: int = 8192        # splat slots (valid mask inside)
    iso_band: float = 0.5       # |tsdf| (trunc units) seeding band
    scale_mult: float = 1.6     # tangent σ = mult × survivor spacing
    normal_scale: float = 0.35  # normal-axis σ / tangent σ (disc shape)
    opacity_init: float = 2.5   # opacity logit at seed time (α ≈ 0.92)
    min_weight: float = 0.0     # observation mask threshold


def _halo_grad(t3: torch.Tensor, nbr: torch.Tensor, cap_b: int):
    """Central-difference gradient of (cap, 8, 8, 8) bricks with
    face-neighbour halos; absent neighbours (index ``cap_b``) keep the own
    edge value (zero gradient across the boundary — never an invented
    crossing). Columns of ``nbr`` in the order +x −x +y −y +z −z."""
    pad = F.pad(t3[:, None], (1, 1, 1, 1, 1, 1), mode="replicate")[:, 0]
    have = nbr < cap_b
    idx = torch.clamp_max(nbr, cap_b - 1).long()
    inner = slice(1, 9)
    planes = (
        (0, t3[idx[:, 0], 0, :, :], (slice(None), 9, inner, inner)),
        (1, t3[idx[:, 1], 7, :, :], (slice(None), 0, inner, inner)),
        (2, t3[idx[:, 2], :, 0, :], (slice(None), inner, 9, inner)),
        (3, t3[idx[:, 3], :, 7, :], (slice(None), inner, 0, inner)),
        (4, t3[idx[:, 4], :, :, 0], (slice(None), inner, inner, 9)),
        (5, t3[idx[:, 5], :, :, 7], (slice(None), inner, inner, 0)),
    )
    for d, plane, sl in planes:
        pad[sl] = torch.where(have[:, d][:, None, None], plane, pad[sl])
    gx = 0.5 * (pad[:, 2:, 1:-1, 1:-1] - pad[:, :-2, 1:-1, 1:-1])
    gy = 0.5 * (pad[:, 1:-1, 2:, 1:-1] - pad[:, 1:-1, :-2, 1:-1])
    gz = 0.5 * (pad[:, 1:-1, 1:-1, 2:] - pad[:, 1:-1, 1:-1, :-2])
    return gx, gy, gz


@torch.no_grad()
def _seed(state: tsdf_ops.TSDFState, tparams: tsdf_ops.TSDFParams,
          sparams: SplatParams, origin: np.ndarray, voxel_size: float):
    """Volume state → (means, normals, log_scales, sh, opacity, valid,
    n_near) tensors with ``capacity`` rows, on the volume's device."""
    cap_b = int(tparams.max_bricks)
    scap = int(sparams.capacity)
    dev = state.tsdf.device
    nbr, block_valid = tsdf_ops.neighbor_table(state, tparams)
    voxel = torch.full((), voxel_size, dtype=torch.float32, device=dev)
    origin_t = torch.as_tensor(np.asarray(origin, np.float32), device=dev)
    tsdf = state.tsdf
    t3 = tsdf.reshape(cap_b, 8, 8, 8)
    gx, gy, gz = _halo_grad(t3, nbr, cap_b)
    grad = torch.stack([gx, gy, gz], dim=-1).reshape(cap_b, 512, 3)
    gnorm = torch.linalg.norm(grad, dim=-1)
    observed = state.weight > sparams.min_weight
    near = (torch.abs(tsdf) < sparams.iso_band) & observed \
        & (gnorm > 1e-6) & block_valid[:, None]

    flat_mask = near.reshape(-1)
    n_near = torch.sum(flat_mask.to(torch.int32))
    idx, v = pointcloud.stratified_indices(flat_mask, scap)
    bk = idx // 512
    intra = idx % 512
    vox = (state.brick_coords[bk].long() * 8
           + torch.stack([intra // 64, (intra // 8) % 8, intra % 8], dim=-1))
    center = (vox.to(torch.float32) + 0.5) * voxel + origin_t[None, :]
    g = grad.reshape(-1, 3)[idx]
    ghat = g / torch.clamp_min(torch.linalg.norm(g, dim=-1, keepdim=True),
                               1e-9)
    sdf_w = tsdf.reshape(-1)[idx] * float(tparams.trunc_voxels) * voxel
    means = center - sdf_w[:, None] * ghat       # snap onto the shell
    normals = -ghat                              # outward (+ inside)
    # Tangent σ from the survivor spacing: stratified thinning keeps every
    # band voxel until capacity, then spreads them — area per splat grows
    # by the thinning ratio, σ by its square root.
    thin = torch.sqrt(torch.clamp_min(
        div(n_near.to(torch.float32), float(scap)), 1.0))
    s_t = torch.log(sparams.scale_mult * voxel * thin)
    s_n = torch.log(sparams.scale_mult * sparams.normal_scale * voxel
                    * thin)
    log_scales = torch.stack([s_t, s_t, s_n]).expand(scap, 3).contiguous()
    sh = torch.zeros((scap, 4, 3), dtype=torch.float32, device=dev)
    sh[:, 0, :] = div(state.rgb.reshape(-1, 3)[idx], 255.0)
    opacity = torch.full((scap,), sparams.opacity_init,
                         dtype=torch.float32, device=dev)
    zero = torch.zeros((), device=dev)
    means = torch.where(v[:, None], means, zero)
    normals = torch.where(v[:, None], normals,
                          torch.tensor([0.0, 0.0, 1.0], device=dev))
    return means, normals, log_scales, sh, opacity, v, n_near


class SplatScene:
    """One renderable splat set: tensors on one device + world framing.

    ``means``/``normals`` are anchored (geometry belongs to the TSDF);
    ``colors_sh``/``opacity``/``log_scales`` are the appearance state
    ``splat/fit.py`` optimizes. ``bbox`` frames the orbit camera so a scene
    renders without its source volume."""

    def __init__(self, params: SplatParams, means, normals, log_scales,
                 colors_sh, opacity, valid, bbox=None, voxel_size=0.0,
                 device=None):
        if device is None and isinstance(means, torch.Tensor):
            device = means.device
        dev = resolve_device(device)
        self.device = dev

        def t(a, dtype=torch.float32):
            return torch.as_tensor(a, device=dev).to(dtype)

        self.params = params
        self.means = t(means)
        self.normals = t(normals)
        self.log_scales = t(log_scales)
        self.colors_sh = t(colors_sh)
        self.opacity = t(opacity)
        self.valid = t(valid, torch.bool)
        self.voxel_size = float(voxel_size)
        if bbox is None:
            pts = self.means[self.valid].cpu().numpy()
            bbox = (pts.min(axis=0), pts.max(axis=0)) if pts.shape[0] \
                else (np.zeros(3, np.float32), np.ones(3, np.float32))
        self.bbox = (np.asarray(bbox[0], np.float32),
                     np.asarray(bbox[1], np.float32))
        self.fit_stats: dict = {}

    @classmethod
    def from_numpy(cls, params: SplatParams, means, normals, log_scales,
                   colors_sh, opacity, valid, bbox=None, voxel_size=0.0,
                   device=None) -> "SplatScene":
        """A scene from host arrays (another package's scene state, say) on
        ``device`` (None means the card)."""
        return cls(params, *(np.array(a) for a in (
            means, normals, log_scales, colors_sh, opacity, valid)),
            bbox=bbox, voxel_size=voxel_size, device=resolve_device(device))

    @property
    def n_splats(self) -> int:
        return int(torch.sum(self.valid.to(torch.int32)))

    @property
    def capacity(self) -> int:
        return int(self.means.shape[0])

    # -- rendering ---------------------------------------------------------

    def camera(self, azim: float, elev: float, width: int, height: int,
               zoom: float = 2.1):
        return sr.orbit_camera(self.bbox[0], self.bbox[1], azim, elev,
                               width, height, zoom=zoom)

    def render_camera(self, camera, cfg: sr.RenderConfig):
        """((H, W, 3) float 0–1, alpha) tensors from an explicit camera
        tuple."""
        return sr.render(self.means, self.normals, self.log_scales,
                         self.colors_sh, self.opacity, self.valid,
                         camera, cfg, device=self.device)

    def render(self, azim: float = 30.0, elev: float = 20.0,
               width: int = 384, height: int = 288,
               zoom: float = 2.1) -> np.ndarray:
        """Novel orbit view → host (H, W, 3) uint8."""
        cfg = sr.RenderConfig(width=int(width), height=int(height))
        img, _ = self.render_camera(
            self.camera(azim, elev, cfg.width, cfg.height, zoom), cfg)
        return sr.to_uint8(img)

    # -- persistence -------------------------------------------------------

    def to_bytes(self) -> bytes:
        """The scene as .npz bytes (the JAX package's v1 schema)."""
        def h(a):
            return a.detach().cpu().numpy()

        buf = _io.BytesIO()
        np.savez_compressed(
            buf, version=np.int32(_SCENE_VERSION),
            params=np.asarray(tuple(self.params), np.float64),
            means=h(self.means), normals=h(self.normals),
            log_scales=h(self.log_scales), colors_sh=h(self.colors_sh),
            opacity=h(self.opacity), valid=h(self.valid),
            bbox_lo=self.bbox[0], bbox_hi=self.bbox[1],
            voxel_size=np.float64(self.voxel_size))
        return buf.getvalue()

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.to_bytes())

    @classmethod
    def from_bytes(cls, data: bytes, device=None) -> "SplatScene":
        try:
            z = np.load(_io.BytesIO(data), allow_pickle=False)
        except (ValueError, OSError, zlib.error) as e:
            raise ValueError(f"not a splat scene archive: {e}")
        if "version" not in z or int(z["version"]) != _SCENE_VERSION:
            raise ValueError(
                f"splat scene version {z.get('version')} unsupported "
                f"(this build reads v{_SCENE_VERSION})")
        p = z["params"]
        params = SplatParams(capacity=int(p[0]), iso_band=float(p[1]),
                             scale_mult=float(p[2]),
                             normal_scale=float(p[3]),
                             opacity_init=float(p[4]),
                             min_weight=float(p[5]))
        return cls.from_numpy(params, z["means"], z["normals"],
                              z["log_scales"], z["colors_sh"], z["opacity"],
                              z["valid"], bbox=(z["bbox_lo"], z["bbox_hi"]),
                              voxel_size=float(z["voxel_size"]),
                              device=device)

    @classmethod
    def load(cls, path: str, device=None) -> "SplatScene":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read(), device=device)

    def stats(self) -> dict:
        return {
            "splats": self.n_splats,
            "capacity": self.capacity,
            "voxel_size": round(self.voxel_size, 6),
            **self.fit_stats,
        }


def seed_from_volume(volume: TSDFVolume,
                     params: SplatParams = SplatParams()) -> SplatScene:
    """TSDF volume → :class:`SplatScene` on the volume's device. A pure
    read: the volume keeps integrating, and re-seeding after more stops is
    the intended refresh."""
    means, normals, log_scales, sh, opacity, valid, n_near = _seed(
        volume.state, volume.params, params, volume.origin,
        volume.voxel_size)
    scene = SplatScene(params, means, normals, log_scales, sh, opacity,
                       valid, voxel_size=volume.voxel_size,
                       device=volume.device)
    n = scene.n_splats
    if n == 0:
        log.warning("splat seeding found no shell voxels (empty or "
                    "unobserved volume)")
    else:
        log.debug("seeded %d/%d splats from %d shell voxels (voxel %.4f)",
                  n, params.capacity, int(n_near), volume.voxel_size)
    return scene


def splat_scene_from_cloud(cloud, params: SplatParams = SplatParams(),
                           depth: int = 7, max_bricks: int = 8192,
                           orientation_mode: str = "radial",
                           device=None) -> SplatScene:
    """Oriented/coloured cloud → fused TSDF → seeded scene, on ``device``
    (None means the card). Sign from the oriented normals, colours from
    ``cloud.colors`` (grey when absent)."""
    from ..models import meshing
    from ..ops.marching_device import _bucket

    dev = resolve_device(device)
    pts = np.asarray(cloud.points, np.float32)
    if pts.shape[0] < 16:
        raise ValueError(f"too few points to splat ({pts.shape[0]})")
    normals = meshing.ensure_oriented_normals(cloud, orientation_mode,
                                              device=dev)
    grid_depth = min(max(int(depth), 5), 9)
    tparams = tsdf_ops.TSDFParams(grid_depth=grid_depth,
                                  max_bricks=int(max_bricks))
    n = pts.shape[0]
    cap = _bucket(n)
    pad = cap - n
    has_colors = cloud.colors is not None and len(cloud.colors) == n
    cols = np.asarray(cloud.colors, np.float32) if has_colors \
        else np.full((n, 3), 180.0, np.float32)
    vol = TSDFVolume.from_bounds(tparams, pts.min(axis=0), pts.max(axis=0),
                                 device=dev)
    vol.integrate_oriented(
        np.concatenate([pts, np.zeros((pad, 3), np.float32)]),
        np.concatenate([cols, np.zeros((pad, 3), np.float32)]),
        np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]),
        np.concatenate([normals.astype(np.float32),
                        np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32),
                                (pad, 1))]))
    scene = seed_from_volume(vol, params)
    log.info("splat scene from %d points: %d splats (depth=%d, "
             "coloured=%s)", n, scene.n_splats, grid_depth, has_colors)
    return scene
