"""Sensor/optics degradation — photoreal capture simulation (counterpart of
the JAX ``models/realism.py``, host numpy).

What separates a rendered pattern stack from a phone photograph of one,
applied in camera order:

1. **defocus / lens blur** — Gaussian PSF;
2. **radial + tangential lens distortion** (Brown–Conrady k1, k2, p1,
   p2) — inverse-map warp, the model ``cv2.undistortPoints`` inverts;
3. **vignetting** — cos⁴ illumination falloff about the principal point;
4. **exposure drift** — per-frame gain jitter;
5. **sensor noise** — signal-dependent shot noise + Gaussian read noise
   on the linear signal;
6. **gamma** — sRGB-style transfer (the phone writes display-referred
   JPEGs);
7. **JPEG round trip** — 8×8 DCT quantization at a configurable quality
   (the reference client uploads JPEG, `frotend/App.tsx:246`), through
   OpenCV where it imports; without it the frame passes through, as in the
   JAX package.

The same seed gives the same stack as the JAX package's.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class SensorParams:
    """Defaults model a mid-range phone camera at ISO ~400."""

    defocus_sigma_px: float = 0.8
    k1: float = 0.06           # radial distortion (barrel)
    k2: float = -0.015
    p1: float = 0.0008         # tangential
    p2: float = -0.0005
    vignette_strength: float = 0.35   # 0 = none, 1 = full cos⁴
    exposure_jitter: float = 0.02     # per-frame gain stddev
    shot_noise: float = 0.02          # stddev at full scale, scales √signal
    read_noise: float = 2.0           # DN at 8 bit
    gamma: float = 2.2
    jpeg_quality: int = 85


def _gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    if sigma <= 0:
        return img
    r = max(1, int(3 * sigma))
    x = np.arange(-r, r + 1, dtype=np.float64)
    kern = np.exp(-0.5 * (x / sigma) ** 2)
    kern /= kern.sum()
    pad = np.pad(img, ((r, r), (0, 0)), mode="edge")
    img = np.apply_along_axis(
        lambda c: np.convolve(c, kern, mode="valid"), 0, pad)
    pad = np.pad(img, ((0, 0), (r, r)), mode="edge")
    return np.apply_along_axis(
        lambda c: np.convolve(c, kern, mode="valid"), 1, pad)


def _distort_warp(h: int, w: int, cam_K: np.ndarray, p: SensorParams):
    """Sampling map: for each DISTORTED output pixel, where to sample the
    ideal image (forward Brown–Conrady applied to the sample position)."""
    fx, fy = cam_K[0, 0], cam_K[1, 1]
    cx, cy = cam_K[0, 2], cam_K[1, 2]
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    x = (u - cx) / fx
    y = (v - cy) / fy
    r2 = x * x + y * y
    radial = 1 + p.k1 * r2 + p.k2 * r2 * r2
    xd = x * radial + 2 * p.p1 * x * y + p.p2 * (r2 + 2 * x * x)
    yd = y * radial + p.p1 * (r2 + 2 * y * y) + 2 * p.p2 * x * y
    return (xd * fx + cx).astype(np.float32), (yd * fy + cy).astype(
        np.float32)


def _bilinear(img: np.ndarray, mu: np.ndarray, mv: np.ndarray) -> np.ndarray:
    h, w = img.shape
    u0 = np.clip(np.floor(mu).astype(np.int64), 0, w - 2)
    v0 = np.clip(np.floor(mv).astype(np.int64), 0, h - 2)
    fu = np.clip(mu - u0, 0.0, 1.0)
    fv = np.clip(mv - v0, 0.0, 1.0)
    a = img[v0, u0] * (1 - fu) + img[v0, u0 + 1] * fu
    b = img[v0 + 1, u0] * (1 - fu) + img[v0 + 1, u0 + 1] * fu
    return a * (1 - fv) + b * fv


def _jpeg_roundtrip(img_u8: np.ndarray, quality: int) -> np.ndarray:
    try:
        import cv2
    except ImportError:
        # Without OpenCV the JPEG stage is skipped; the rest of the chain
        # still applies.
        log.debug("jpeg roundtrip unavailable (no cv2); frame passed through")
        return img_u8
    ok, buf = cv2.imencode(".jpg", img_u8,
                           [cv2.IMWRITE_JPEG_QUALITY, quality])
    return cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE) if ok else img_u8


def degrade_frame(frame: np.ndarray, cam_K: np.ndarray,
                  params: SensorParams = SensorParams(),
                  rng: np.random.Generator | None = None) -> np.ndarray:
    """One ideal (H, W) uint8 render → photoreal capture (H, W) uint8."""
    if rng is None:
        rng = np.random.default_rng(0)
    p = params
    h, w = frame.shape
    img = frame.astype(np.float64) / 255.0

    img = _gaussian_blur(img, p.defocus_sigma_px)
    mu, mv = _distort_warp(h, w, cam_K, p)
    img = _bilinear(img, mu, mv)

    fx = cam_K[0, 0]
    v, u = np.mgrid[0:h, 0:w]
    r2 = ((u - cam_K[0, 2]) ** 2 + (v - cam_K[1, 2]) ** 2) / (fx * fx)
    cos4 = 1.0 / (1.0 + r2) ** 2
    img = img * (1 - p.vignette_strength + p.vignette_strength * cos4)

    img = img * (1.0 + rng.normal(0.0, p.exposure_jitter))
    noise = rng.normal(0.0, 1.0, img.shape) * (
        p.shot_noise * np.sqrt(np.clip(img, 0.0, 1.0))) \
        + rng.normal(0.0, p.read_noise / 255.0, img.shape)
    img = np.clip(img + noise, 0.0, 1.0)

    img = img ** (1.0 / p.gamma)
    img_u8 = np.round(img * 255.0).astype(np.uint8)
    return _jpeg_roundtrip(img_u8, p.jpeg_quality)


def degrade_stack(stack: np.ndarray, cam_K: np.ndarray,
                  params: SensorParams = SensorParams(),
                  seed: int = 0) -> np.ndarray:
    """(F, H, W) uint8 ideal stack → photoreal stack, per-frame noise."""
    rng = np.random.default_rng(seed)
    return np.stack([degrade_frame(f, cam_K, params, rng) for f in stack])
