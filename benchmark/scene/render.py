"""The benchmark's inputs rendered on the device: the PyTorch form of the
frame model in ``frozen_numpy.py`` (rays, the sphere-and-wall raycast, the
projector lookup, the shading), plus the camera's read noise drawn from a
``torch.Generator`` seeded by the run. Geometry is float64, as in the NumPy
copy; without noise a stop equals ``frozen_numpy.render_stop`` up to the
rounding of a projector coordinate that lies on a half pixel."""

from __future__ import annotations

import math

import numpy as np
import torch

from . import frozen_numpy


def bits_for(n: int) -> int:
    return int(math.ceil(math.log2(n)))


class Rig:
    """The rig of a configuration: camera and projector sizes, matrices
    (``frozen_numpy.default_calibration``) and the Gray-code frames."""

    def __init__(self, rig: dict):
        self.cam_h, self.cam_w = int(rig["cam_height"]), int(rig["cam_width"])
        self.proj_w, self.proj_h = int(rig["proj_width"]), int(rig["proj_height"])
        self.brightness = int(rig.get("brightness", 200))
        self.col_bits = bits_for(self.proj_w)
        self.row_bits = bits_for(self.proj_h)
        self.matrices = frozen_numpy.default_calibration(
            self.cam_h, self.cam_w, self.proj_w, self.proj_h)

    @property
    def n_frames(self) -> int:
        return 2 + 2 * self.col_bits + 2 * self.row_bits


def pattern_frames(rig: Rig, device) -> torch.Tensor:
    """(F, proj_h, proj_w) uint8 on ``device``: white, black, then a
    (pattern, inverse) pair per column bit and per row bit, MSB first."""
    def planes(n, n_bits):
        idx = torch.arange(n, dtype=torch.int64, device=device)
        g = idx ^ (idx >> 1)
        shifts = torch.arange(n_bits - 1, -1, -1, device=device)[:, None]
        return ((g[None, :] >> shifts) & 1).to(torch.uint8)

    b, h, w = rig.brightness, rig.proj_h, rig.proj_w
    cols = planes(w, rig.col_bits)[:, None, :].expand(-1, h, -1) * b
    rows = planes(h, rig.row_bits)[:, :, None].expand(-1, -1, w) * b
    col_pairs = torch.stack([cols, b - cols], 1).reshape(-1, h, w)
    row_pairs = torch.stack([rows, b - rows], 1).reshape(-1, h, w)
    white = torch.full((1, h, w), b, dtype=torch.uint8, device=device)
    return torch.cat([white, torch.zeros_like(white), col_pairs, row_pairs])


def rotated_spheres(scene: dict, angle_deg: float):
    return frozen_numpy.rotated_spheres(
        [(s[:3], s[3], s[4]) for s in scene["spheres"]], scene["pivot"],
        angle_deg)


class Renderer:
    """Renders stops of one scene with one rig on ``device``."""

    def __init__(self, scene: dict, rig: Rig, device):
        self.scene, self.rig, self.dev = scene, rig, torch.device(device)
        f64 = dict(dtype=torch.float64, device=self.dev)
        cam_K, proj_K, R, T = rig.matrices
        kinv = torch.tensor(np.linalg.inv(cam_K), **f64)
        v, u = torch.meshgrid(torch.arange(rig.cam_h, **f64),
                              torch.arange(rig.cam_w, **f64), indexing="ij")
        pix = torch.stack([u, v, torch.ones_like(u)], -1).reshape(-1, 3)
        rays = pix @ kinv.T
        self.rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
        self.R = torch.tensor(R, **f64)
        self.T = torch.tensor(T, **f64)
        self.pK = proj_K
        self.frames = pattern_frames(rig, self.dev).reshape(rig.n_frames, -1)

    def _raycast(self, spheres):
        rays = self.rays
        n = rays.shape[0]
        t_best = torch.full((n,), math.inf, dtype=torch.float64,
                            device=self.dev)
        albedo = torch.zeros_like(t_best)
        zero = torch.zeros((), dtype=torch.float64, device=self.dev)
        for c, r, a in spheres:
            c = torch.tensor(c, dtype=torch.float64, device=self.dev)
            b = rays @ c
            disc = b * b - (c @ c - r ** 2)
            ok = disc > 0
            sq = torch.sqrt(torch.where(ok, disc, zero))
            t0, t1 = b - sq, b + sq
            t = torch.where(t0 > 1e-6, t0, t1)
            ok &= t > 1e-6
            closer = ok & (t < t_best)
            t_best = torch.where(closer, t, t_best)
            albedo = torch.where(closer, torch.full_like(albedo, a), albedo)
        wall_z = self.scene.get("wall_z")
        if wall_z is not None:
            rz = rays[:, 2]
            ok = rz > 1e-6
            t = torch.where(ok, wall_z / torch.where(ok, rz, zero + 1.0),
                            zero + math.inf)
            closer = ok & (t < t_best)
            t_best = torch.where(closer, t, t_best)
            albedo = torch.where(
                closer, torch.full_like(albedo, self.scene["wall_albedo"]),
                albedo)
        hit = torch.isfinite(t_best)
        return torch.where(hit, t_best, zero), albedo, hit

    def stop(self, angle_deg: float, generator: torch.Generator | None = None,
             noise_dn: float = 0.0) -> torch.Tensor:
        """(F, H, W) uint8 stack of the scene turned by ``angle_deg``; read
        noise of ``noise_dn`` grey levels (one sigma) from ``generator``."""
        rig = self.rig
        t, albedo, hit = self._raycast(rotated_spheres(self.scene, angle_deg))
        P = (t[:, None] * self.rays) @ self.R.T + self.T[None, :]
        z = P[:, 2]
        ok_z = z > 1e-6
        zs = torch.where(ok_z, z, torch.ones_like(z))
        k = self.pK
        u = torch.where(ok_z, (k[0, 0] * P[:, 0] + k[0, 2] * z) / zs,
                        torch.full_like(z, -1.0))
        v = torch.where(ok_z, (k[1, 1] * P[:, 1] + k[1, 2] * z) / zs,
                        torch.full_like(z, -1.0))
        ui = torch.round(u).to(torch.int64)
        vi = torch.round(v).to(torch.int64)
        lit = hit & ok_z & (ui >= 0) & (ui < rig.proj_w) & (vi >= 0) \
            & (vi < rig.proj_h)
        idx = vi.clamp(0, rig.proj_h - 1) * rig.proj_w \
            + ui.clamp(0, rig.proj_w - 1)
        out = torch.empty((rig.n_frames, rig.cam_h * rig.cam_w),
                          dtype=torch.uint8, device=self.dev)
        amb = float(self.scene["ambient"])
        base = torch.where(hit, amb, 0.0)
        for f in range(rig.n_frames):
            val = torch.where(lit, albedo * self.frames[f, idx].to(
                torch.float64) + amb, base)
            if noise_dn > 0:
                val = val + noise_dn * torch.randn(
                    val.shape, generator=generator, device=self.dev,
                    dtype=torch.float32).to(torch.float64)
            out[f] = val.clamp(0, 255).to(torch.uint8)
        return out.reshape(rig.n_frames, rig.cam_h, rig.cam_w)
