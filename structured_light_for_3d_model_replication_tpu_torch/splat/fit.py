"""View-dependent appearance fitting against the captured per-stop RGB
(counterpart of the JAX ``splat/fit.py``).

Every structured-light stop already yields a dense RGB frame and a pose;
this module re-uses them as supervision: render the splat scene from a
stop's camera, compare to that stop's (valid-masked, subsampled) colours,
descend. Geometry is frozen — means and normals stay anchored on the TSDF
shell — and only appearance moves: per-splat SH colour (degree 1), opacity
logit and log-scales.

The optimizer is Adam with the JAX package's constants, bias correction
from a float step counter on the device and the ``band_decay`` multiply on
the linear SH bands after each step. Gradients come from ``torch.autograd``
through the plain composite (``render(..., use_kernel=False)``): the CUDA
composite kernel has no backward and is never taken here. The parameters
are the fit's own leaf tensors, updated in place under ``torch.no_grad()``,
and no host value is read per iteration (only the first and last losses,
at the end).
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..ops import splat_render as sr

log = logging.getLogger(__name__)

_BETA1, _BETA2, _EPS = 0.9, 0.999, 1e-8


def psnr(img, ref, mask=None) -> float:
    """PSNR in dB between images in 0–1 scale; ``mask`` restricts the mean
    to covered pixels (a captured stop's decode-valid region)."""
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    a = np.asarray(img, np.float64)
    b = np.asarray(ref, np.float64)
    if mask is not None:
        m = np.asarray(mask, bool)
        if not m.any():
            return 0.0
        a = a[m]
        b = b[m]
    mse = float(np.mean((a - b) ** 2))
    return float(10.0 * np.log10(1.0 / max(mse, 1e-12)))


def fit_pinhole(points, valid, height: int, width: int):
    """Recover ``(fx, fy, cx, cy)`` from ONE decoded stop's camera-frame
    points — two tiny least squares (u = fx·x/z + cx over the pixel grid).
    Returns None when the stop has too few usable pixels."""
    pts = np.asarray(points, np.float64).reshape(height, width, 3)
    val = np.asarray(valid, bool).reshape(height, width)
    z = pts[..., 2]
    ok = val & (z > 1e-6)
    if int(ok.sum()) < 64:
        return None
    jj, ii = np.meshgrid(np.arange(width, dtype=np.float64),
                         np.arange(height, dtype=np.float64))
    xz = (pts[..., 0] / np.where(ok, z, 1.0))[ok]
    yz = (pts[..., 1] / np.where(ok, z, 1.0))[ok]
    one = np.ones_like(xz)
    (fx, cx), *_ = np.linalg.lstsq(np.stack([xz, one], 1), jj[ok],
                                   rcond=None)
    (fy, cy), *_ = np.linalg.lstsq(np.stack([yz, one], 1), ii[ok],
                                   rcond=None)
    if not (np.isfinite([fx, fy, cx, cy]).all() and fx > 0 and fy > 0):
        return None
    return float(fx), float(fy), float(cx), float(cy)


def frame_target(colors, valid, height: int, width: int, stride: int):
    """One dense stop frame → the fit-resolution target: strided subsample
    of the (H, W) pixel grid. ``colors`` is a decode frame in 0–255 scale,
    always divided by 255. Returns ``(target (h, w, 3) f32 0–1, mask (h, w)
    bool)`` host arrays; the mask is the decode-valid region eroded by one
    fit-resolution pixel (silhouette pixels mix foreground and
    background)."""
    img = np.asarray(colors).reshape(height, width, 3)
    msk = np.asarray(valid, bool).reshape(height, width)
    t = img[::stride, ::stride].astype(np.float32) / 255.0
    m = msk[::stride, ::stride]
    er = m.copy()
    er[1:] &= m[:-1]
    er[:-1] &= m[1:]
    er[:, 1:] &= m[:, :-1]
    er[:, :-1] &= m[:, 1:]
    return np.clip(t, 0.0, 1.0), er


def _loss(fit_params, frozen, frame, mask, cam, cfg: sr.RenderConfig):
    colors_sh, opacity, log_scales = fit_params
    means, normals, valid = frozen
    img, _ = sr._render_fn(means, normals, log_scales, colors_sh, opacity,
                           valid, *cam, cfg, use_kernel=False)
    m = mask.to(torch.float32)[..., None]
    return torch.sum(m * (img - frame) ** 2) \
        / torch.clamp_min(torch.sum(m) * 3.0, 1.0)


def _fit_step(fit_params, m1, m2, t, frozen, frame, mask, cam,
              cfg: sr.RenderConfig, lrs, band_decay: float):
    """One Adam step over ``fit_params`` = (colors_sh, opacity, log_scales)
    leaf tensors, updated in place with their moments ``m1``/``m2`` and the
    0-d step counter ``t``. Returns the step's loss (a 0-d tensor)."""
    loss = _loss(fit_params, frozen, frame, mask, cam, cfg)
    grads = torch.autograd.grad(loss, fit_params)
    with torch.no_grad():
        t += 1.0
        bc1 = 1.0 - _BETA1 ** t
        bc2 = 1.0 - _BETA2 ** t
        for p, g, a, b, lr in zip(fit_params, grads, m1, m2, lrs):
            a.copy_(_BETA1 * a + (1.0 - _BETA1) * g)
            b.copy_(_BETA2 * b + (1.0 - _BETA2) * g * g)
            p.sub_(lr * (a / bc1) / (torch.sqrt(b / bc2) + _EPS))
        fit_params[0][:, 1:, :] *= float(np.float32(band_decay))
    return loss.detach()


def fit_appearance(scene, frames, masks, cameras,
                   fit_cfg: sr.RenderConfig | None = None,
                   iters: int = 60, lr_color: float = 0.08,
                   lr_opacity: float = 0.05, lr_scale: float = 0.01,
                   band_decay: float = 0.997):
    """Fit the scene's appearance against captured views; the scene gets new
    appearance tensors (those it held are not modified).

    ``frames`` (F, h, w, 3) float 0–1, ``masks`` (F, h, w) bool,
    ``cameras`` a list of F render camera tuples (``stop_camera`` at
    fit-resolution intrinsics). ``fit_cfg`` defaults to the frame shape.
    Frames are visited round-robin. Returns the scene with ``fit_stats``
    filled (loss trajectory ends, seconds, iterations)."""
    dev = scene.device
    frames = torch.as_tensor(np.asarray(frames), device=dev).to(
        torch.float32)
    masks = torch.as_tensor(np.asarray(masks), device=dev).to(torch.bool)
    F, h, w = frames.shape[:3]
    if fit_cfg is None:
        fit_cfg = sr.RenderConfig(width=w, height=h)
    cams = [sr.camera_tensors(c, dev) for c in cameras]
    lrs = (float(lr_color), float(lr_opacity), float(lr_scale))
    fit_params = tuple(p.detach().clone().requires_grad_(True)
                       for p in (scene.colors_sh, scene.opacity,
                                 scene.log_scales))
    m1 = tuple(torch.zeros_like(p) for p in fit_params)
    m2 = tuple(torch.zeros_like(p) for p in fit_params)
    t = torch.zeros((), dtype=torch.float32, device=dev)
    frozen = (scene.means, scene.normals, scene.valid)
    t0 = time.monotonic()
    loss0 = loss = None
    for it in range(int(iters)):
        i = it % F
        loss = _fit_step(fit_params, m1, m2, t, frozen, frames[i], masks[i],
                         cams[i], fit_cfg, lrs, band_decay)
        if it == 0:
            loss0 = loss  # device value — no per-iteration host read
    first = float(loss0) if loss0 is not None else None
    last = float(loss) if loss is not None else None
    scene.colors_sh, scene.opacity, scene.log_scales = (
        p.detach() for p in fit_params)
    scene.fit_stats = {
        "fit_iters": int(iters),
        "fit_frames": int(F),
        "fit_loss_first": round(first, 6) if first is not None else None,
        "fit_loss_last": round(last, 6) if last is not None else None,
        "fit_seconds": round(time.monotonic() - t0, 3),
    }
    log.debug("appearance fit: %d iters over %d frames, loss %.5f -> %.5f "
              "in %.2fs", iters, F, first or 0.0, last or 0.0,
              scene.fit_stats["fit_seconds"])
    return scene
