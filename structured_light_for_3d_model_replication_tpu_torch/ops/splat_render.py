"""Tile-binned Gaussian-splat rasterizer (counterpart of the JAX
``ops/splat_render.py``).

The appearance tier's renderer (``splat/``): anisotropic 3D Gaussians
anchored on the TSDF shell are projected to screen-space conics (the EWA
recipe), binned into fixed-size image tiles, depth-sorted front-to-back per
tile and alpha-composited:

* tile binning is a dense (tiles, splats) overlap mask and the K nearest
  members of every tile by depth (``RenderConfig.max_per_tile``), the far
  tail truncated;
* the per-tile composite exists twice with one numerical contract
  (:mod:`.splat_composite`): the plain PyTorch form, differentiable — the
  fit in ``splat/fit.py`` rides its gradients — and the hand-written CUDA
  kernel ``csrc/composite.cu``, which ``render`` takes on a CUDA tensor
  unless told ``use_kernel=False``.

Camera model: pinhole ``u = fx·x/z + cx`` after the world→camera rigid map
``x = R_wc (p − eye)``; :func:`orbit_camera` reproduces the JAX package's
orbit conventions (y-up turntable, image +v down) and :func:`stop_camera`
turns a session stop pose into the same tuple for fitting against captured
RGB.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import div, resolve_device
from . import splat_composite

#: Background of the JAX package's viewer, so mesh and splat previews read
#: as one family.
BG_DEFAULT = (18, 20, 26)


class RenderConfig(NamedTuple):
    """Fixed half of a render (the JAX package's fields and defaults).

    ``tile``/``max_per_tile`` trade memory for depth capacity: each tile
    composites its ``max_per_tile`` NEAREST splats (truncating the far
    tail), so a tile must be small enough that K covers the front surface
    across the tile's whole area."""

    width: int = 384
    height: int = 288
    tile: int = 8              # square pixel tiles
    max_per_tile: int = 128    # K nearest splats composited per tile
    bg: tuple = BG_DEFAULT     # RGB 0-255

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile)


# ---------------------------------------------------------------------------
# Cameras (host-side helpers, numpy)
# ---------------------------------------------------------------------------


def orbit_camera(lo, hi, azim_deg: float, elev_deg: float,
                 width: int, height: int, zoom: float = 2.1,
                 fov_scale: float = 1.15):
    """Orbit pinhole around the bbox ``[lo, hi]`` (y-up axis, image +v
    down) as the ``(R_wc, eye, fx, fy, cx, cy)`` tuple :func:`render`
    takes."""
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    center = 0.5 * (lo + hi)
    radius = max(float(np.linalg.norm(hi - lo)) * 0.5, 1e-6)
    dist = zoom * radius
    az = np.deg2rad(azim_deg)
    el = np.deg2rad(elev_deg)
    off = np.array([np.sin(az) * np.cos(el), np.sin(el),
                    -np.cos(az) * np.cos(el)])
    eye = center + dist * off
    fwd = center - eye
    fwd /= np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(fwd, up)
    nr = np.linalg.norm(right)
    right = np.array([1.0, 0.0, 0.0]) if nr < 1e-9 else right / nr
    dn = np.cross(fwd, right)
    R = np.stack([right, -dn, fwd])
    f = fov_scale * min(width, height) * 0.5
    return (R.astype(np.float32), eye.astype(np.float32),
            np.float32(f), np.float32(f),
            np.float32((width - 1) * 0.5), np.float32((height - 1) * 0.5))


def stop_camera(pose, fx, fy, cx, cy):
    """A session stop's camera as a render tuple: ``pose`` is the stop's
    camera→model 4×4, so world→camera is its inverse rigid map."""
    pose = np.asarray(pose, np.float64)
    R = pose[:3, :3].T
    eye = pose[:3, 3]
    return (R.astype(np.float32), eye.astype(np.float32),
            np.float32(fx), np.float32(fy), np.float32(cx),
            np.float32(cy))


# ---------------------------------------------------------------------------
# Projection + binning + composite
# ---------------------------------------------------------------------------


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True),
                               1e-9)


def _project(means, normals, log_scales, colors_sh, opacity, valid,
             R_wc, eye, fx, fy, cx, cy, cfg: RenderConfig):
    """World splats → screen records: (u, v, z, radius, conic a, b, c,
    colour (S, 3), alpha₀, visible), all (S,)-shaped but the colour; EWA
    projection of the anisotropic covariance built on the splat's normal
    frame. Camera scalars are 0-d tensors, so every quotient is a true
    division on every device."""
    dev = means.device
    n = _unit(normals)
    helper = torch.where(torch.abs(n[:, 2:3]) < 0.9,
                         torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32,
                                      device=dev),
                         torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32,
                                      device=dev))
    t1 = _unit(torch.linalg.cross(n, helper, dim=-1))
    t2 = torch.linalg.cross(n, t1, dim=-1)
    basis = torch.stack([t1, t2, n], dim=-1)           # (S, 3, 3) columns
    s = torch.exp(log_scales)                          # (S, 3)

    x = (means - eye[None, :]) @ R_wc.T                # (S, 3) camera
    z = x[:, 2]
    in_front = z > 1e-6
    one = torch.ones((), device=dev)
    zs = torch.where(in_front, z, one)
    u = fx * x[:, 0] / zs + cx
    v = fy * x[:, 1] / zs + cy

    # EWA: Σ2d = J (R B) diag(s²) (R B)ᵀ Jᵀ, J the projective Jacobian.
    A = (R_wc @ basis) * s[:, None, :]                 # (S, 3, 3)
    j00 = fx / zs
    j11 = fy / zs
    j02 = -fx * x[:, 0] / (zs * zs)
    j12 = -fy * x[:, 1] / (zs * zs)
    r0 = j00[:, None] * A[:, 0, :] + j02[:, None] * A[:, 2, :]
    r1 = j11[:, None] * A[:, 1, :] + j12[:, None] * A[:, 2, :]
    c00 = torch.sum(r0 * r0, dim=-1) + 0.3             # 0.3 px low-pass
    c11 = torch.sum(r1 * r1, dim=-1) + 0.3
    c01 = torch.sum(r0 * r1, dim=-1)
    det = c00 * c11 - c01 * c01
    inv_det = one / torch.maximum(det, torch.full((), 1e-12, device=dev))
    conic_a = c11 * inv_det
    conic_b = -c01 * inv_det
    conic_c = c00 * inv_det
    mid = 0.5 * (c00 + c11)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam))

    # Degree-1 SH on the per-splat viewing direction (the 3DGS recipe).
    d = _unit(means - eye[None, :])
    color = colors_sh[:, 0, :] + torch.einsum(
        "skc,sk->sc", colors_sh[:, 1:4, :], d)         # (S, 3)
    alpha0 = torch.sigmoid(opacity)

    W, H = cfg.width, cfg.height
    visible = (valid & in_front & (det > 1e-12)
               & (u + radius > 0) & (u - radius < W)
               & (v + radius > 0) & (v - radius < H))
    return u, v, z, radius, conic_a, conic_b, conic_c, color, alpha0, \
        visible


def _tile_origins(cfg: RenderConfig, device):
    T = cfg.tile
    tx = torch.arange(cfg.tiles_x, dtype=torch.float32, device=device) * T
    ty = torch.arange(cfg.tiles_y, dtype=torch.float32, device=device) * T
    return tx.repeat(cfg.tiles_y), ty.repeat_interleave(cfg.tiles_x)


def _bin_tiles(u, v, z, radius, visible, cfg: RenderConfig):
    """(tiles, K) nearest-first splat indices + membership mask: a dense
    tile×splat overlap test, then the K smallest depths of each tile's
    members. ``lax.top_k`` puts the lower splat index first on equal
    depths, and ``torch.topk`` promises no order for ties, so the selection
    runs on one int64 key per pair, the depth's float bits above the splat
    index: all keys differ, and their order is depth first, then index.
    Members lie in front of the camera (z > 1e-6), where a positive
    float's bits order as the float; a non-member's key is +inf's bits, as
    the JAX key's +inf."""
    T = cfg.tile
    x0, y0 = _tile_origins(cfg, u.device)
    member = (visible[None, :]
              & (u[None, :] + radius[None, :] >= x0[:, None])
              & (u[None, :] - radius[None, :] < x0[:, None] + T)
              & (v[None, :] + radius[None, :] >= y0[:, None])
              & (v[None, :] - radius[None, :] < y0[:, None] + T))
    S = u.shape[0]
    inf_bits = 0x7F800000             # +inf as float32 bits
    zbits = z.detach().contiguous().view(torch.int32).to(torch.int64)
    key = torch.where(member, zbits[None, :], inf_bits) * (1 << 32) \
        + torch.arange(S, dtype=torch.int64, device=u.device)[None, :]
    k = min(cfg.max_per_tile, S)  # tiny scenes: K ≤ S
    _, idx = torch.topk(key, k, dim=1, largest=False, sorted=True)
    ok = torch.gather(member, 1, idx)
    return idx, ok, x0, y0


def _tile_records(means, normals, log_scales, colors_sh, opacity, valid,
                  R_wc, eye, fx, fy, cx, cy, cfg: RenderConfig):
    """The composite's inputs: ten (NT, K) record planes (u, v, conic a, b,
    c, colour r, g, b clipped to 0–1, alpha₀, membership) and the (NT,)
    tile origins. All inputs are tensors on one device (camera scalars 0-d
    float32)."""
    (u, v, z, radius, ca, cb, cc, color, alpha0,
     visible) = _project(means, normals, log_scales, colors_sh, opacity,
                         valid, R_wc, eye, fx, fy, cx, cy, cfg)
    idx, ok, x0, y0 = _bin_tiles(u, v, z, radius, visible, cfg)
    zero = torch.zeros((), device=u.device)

    def take(a):
        # Unselected slots are zeroed after a valid gather: a masked-out
        # splat may carry arbitrary (even non-finite) values, and 0 · NaN
        # downstream would poison the whole tile.
        return torch.where(ok, a[idx], zero)             # (NT, K)

    # minimum/maximum, not clamp: at a colour of exactly 0 or 1 (a
    # saturated fused RGB) they split the gradient as jnp.clip does.
    col = torch.minimum(torch.maximum(color, zero),
                        torch.ones((), device=u.device))
    recs = (take(u), take(v), take(ca), take(cb), take(cc),
            take(col[:, 0]), take(col[:, 1]), take(col[:, 2]),
            take(alpha0), ok)
    return recs, x0, y0


def _render_fn(means, normals, log_scales, colors_sh, opacity, valid,
               R_wc, eye, fx, fy, cx, cy, cfg: RenderConfig,
               use_kernel: bool = False):
    """Full render: returns ((H, W, 3) float 0–1, (H, W) alpha). All inputs
    are tensors on one device (camera scalars 0-d float32)."""
    recs, x0, y0 = _tile_records(means, normals, log_scales, colors_sh,
                                 opacity, valid, R_wc, eye, fx, fy, cx, cy,
                                 cfg)
    if use_kernel:
        rgb, a_out = splat_composite.composite(*recs, x0, y0, cfg.tile)
    else:
        rgb, a_out = splat_composite.composite_reference(*recs, x0, y0,
                                                         cfg.tile)

    # Tile sheet → image crop + background blend.
    TY, TX, T = cfg.tiles_y, cfg.tiles_x, cfg.tile
    sheet = rgb.reshape(TY, TX, T, T, 3).permute(0, 2, 1, 3, 4)
    img = sheet.reshape(TY * T, TX * T, 3)[:cfg.height, :cfg.width]
    a_sheet = a_out.reshape(TY, TX, T, T).permute(0, 2, 1, 3)
    a_img = a_sheet.reshape(TY * T, TX * T)[:cfg.height, :cfg.width]
    bg = div(torch.tensor(cfg.bg, dtype=torch.float32, device=x0.device),
             255.0)
    img = img + (1.0 - a_img)[..., None] * bg[None, None, :]
    return img, a_img


def camera_tensors(camera, device):
    """An ``(R_wc, eye, fx, fy, cx, cy)`` tuple as float32 tensors on
    ``device`` (the scalars 0-d)."""
    return tuple(torch.as_tensor(np.asarray(c, np.float32),
                                 dtype=torch.float32, device=device)
                 if not isinstance(c, torch.Tensor)
                 else c.to(device=device, dtype=torch.float32)
                 for c in camera)


def render(means, normals, log_scales, colors_sh, opacity, valid,
           camera, cfg: RenderConfig = RenderConfig(),
           use_kernel: bool | None = None, device=None):
    """Render one view; ``camera`` is an ``(R_wc, eye, fx, fy, cx, cy)``
    tuple (:func:`orbit_camera` / :func:`stop_camera`). Returns ``((H, W, 3)
    float32 0–1, (H, W) float32 alpha)`` tensors on the splats' device:
    ``device``, else ``means``'s when it is a tensor, else the card.

    ``use_kernel=None`` takes the composite kernel on a CUDA tensor and the
    plain version on the CPU; ``use_kernel=False`` is the gradient path
    (``splat/fit.py`` always fits through it)."""
    if device is None:
        device = means.device if isinstance(means, torch.Tensor) else None
    dev = resolve_device(device)
    if use_kernel is None:
        use_kernel = dev.type == "cuda"

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, device=dev).to(dtype)

    return _render_fn(
        t(means), t(normals), t(log_scales), t(colors_sh), t(opacity),
        t(valid, torch.bool), *camera_tensors(camera, dev), cfg,
        bool(use_kernel))


def to_uint8(img) -> np.ndarray:
    """(H, W, 3) float 0–1 → host uint8 image (the PNG writer's input)."""
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    return np.clip(np.round(np.asarray(img) * 255.0), 0,
                   255).astype(np.uint8)
