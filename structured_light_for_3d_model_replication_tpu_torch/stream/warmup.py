"""Session-lane warmup: run the streaming chain once at replica start
(counterpart of the JAX package's ``stream/warmup.py``).

The port has no jit cache to fill, but a session's first stops still pay
first-use costs on the card: the kernel library's build, the caching
allocator growing its pools for the session's shapes, and the first
cuBLAS/cuSOLVER calls creating their handles and workspaces (the
registration's and the pose refine's solves). This module runs a tiny
deterministic 3-stop synthetic ring through a throwaway
:class:`~.session.IncrementalSession` at the REAL bucket pixel count and
the REAL session params, on the session's device, so a recovered or
adopted session finds all of that done:

* stop 1 — subsample + first fuse + first preview;
* stop 2 — registration preprocess + edge ICP + consensus;
* stop 3 — the fixed-window pose-graph refine (needs ≥ 2 edges).

Not warmed (finalize-only): the full-ring pose solve, the axis-prior
re-pass and the finalize merge.

The synthetic stops are a rotated sphere cap — enough structure for
RANSAC/ICP to run its full path; the result is discarded. Covisibility
gating is off for the warm-up so no stop is skipped.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..utils.log import get_logger
from .session import IncrementalSession, StreamParams

log = get_logger(__name__)


def _synthetic_stop(n_pixels: int, m_valid: int, step_deg: float,
                    k: int) -> tuple:
    """One deterministic fake decoded stop: ``m_valid`` points on a
    bumpy sphere (radius 80 @ z=500, the synthetic-rig scale), rotated
    ``k`` turntable steps; the remaining slots are invalid zeros."""
    m = min(m_valid, n_pixels)
    i = np.arange(m, dtype=np.float64)
    phi = np.pi * (3.0 - np.sqrt(5.0))
    y = 1.0 - 2.0 * (i + 0.5) / m
    r = np.sqrt(np.maximum(1.0 - y * y, 0.0))
    pts = np.stack([np.cos(phi * i) * r, y, np.sin(phi * i) * r], axis=1)
    # Low-frequency bumps give ICP/FPFH non-degenerate structure.
    pts *= (1.0 + 0.1 * np.sin(3.0 * pts[:, :1]) * np.cos(2.0 * pts[:, 2:]))
    a = np.deg2rad(step_deg) * k
    rot = np.array([[np.cos(a), 0.0, np.sin(a)],
                    [0.0, 1.0, 0.0],
                    [-np.sin(a), 0.0, np.cos(a)]])
    pts = pts @ rot.T * 80.0 + np.array([0.0, 0.0, 500.0])
    points = np.zeros((n_pixels, 3), np.float32)
    points[:m] = pts.astype(np.float32)
    # uint8, as decode hands sessions their colors.
    colors = np.zeros((n_pixels, 3), np.uint8)
    colors[:m] = 128
    valid = np.zeros(n_pixels, bool)
    valid[:m] = True
    return points, colors, valid


def _warm_splat_lane(mesher, frame_shape) -> bool:
    """Drive the splat previewer's observe → seed → fit → render chain
    once with a pinhole-consistent synthetic frame (a fronto-parallel
    textured plane — the sphere stops above already populated the
    volume; this frame exists so the pinhole fit succeeds and the fit
    and the composite kernel run). The result is discarded."""
    h, w = int(frame_shape[0]), int(frame_shape[1])
    f = 0.8 * w
    cx, cy = (w - 1) * 0.5, (h - 1) * 0.5
    z = 500.0
    jj, ii = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    points = np.stack([(jj - cx) * z / f, (ii - cy) * z / f,
                       np.full((h, w), z, np.float32)],
                      axis=-1).reshape(-1, 3)
    colors = np.zeros((h * w, 3), np.uint8)
    colors[:, 0] = (np.arange(h * w) % 255).astype(np.uint8)
    valid = np.ones(h * w, bool)
    if not mesher.observe_frame(points, colors, valid, np.eye(4),
                                (h, w)):
        return False
    return mesher.render_png(30.0, 20.0) is not None


def warm_session_programs(params: StreamParams, n_pixels: int,
                          col_bits: int = 8, row_bits: int = 8,
                          stops: int = 3,
                          frame_shape: tuple | None = None,
                          device=None) -> dict:
    """Run the session lane once for ``(params, n_pixels)`` on ``device``
    (None means the card).

    Returns a small report dict (seconds, stops, representation). Safe
    to call more than once. ``frame_shape`` (H, W) warms the splat
    appearance lane too (``representation="splat"``): seed, fit and the
    default-size render run at replica start instead of inside the first
    render request."""
    t0 = time.monotonic()
    # Gates and covisibility are host-side; disabling them guarantees
    # every synthetic stop actually FUSES — a skipped stop would leave its
    # path cold.
    wp = dataclasses.replace(params, gates=None, covis=False,
                             preview_every=1)
    sess = IncrementalSession(
        calib=None, col_bits=col_bits, row_bits=row_bits, params=wp,
        scan_id="warmup-session", device=device)
    m_valid = min(n_pixels, 8192)
    # step_deg may be None (ring step unknown until a real session);
    # the synthetic rotation only shapes geometry.
    step = wp.merge.step_deg if wp.merge.step_deg else 15.0
    for k in range(max(3, int(stops))):
        points, colors, valid = _synthetic_stop(
            n_pixels, m_valid, step, k)
        sess.add_decoded(points, colors, valid)
    rendered = False
    if wp.representation == "splat" and frame_shape is not None:
        rendered = _warm_splat_lane(sess._mesher, frame_shape)
    report = {
        "seconds": round(time.monotonic() - t0, 3),
        "stops": sess.stops_fused,
        "pixels": int(n_pixels),
        "representation": wp.representation,
        "render_warmed": rendered,
    }
    log.info("session-lane warmup: %d synthetic stops @ %d px "
             "(%s previews) in %.1fs", report["stops"], n_pixels,
             wp.representation, report["seconds"])
    return report
