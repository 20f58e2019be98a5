"""SplatPreviewMesher: the rendered-preview lane of a streaming session
(counterpart of the JAX ``splat/preview.py``).

Extends the TSDF previewer (``fusion/preview.py``: geometry previews stay
the extracted coloured mesh) with the appearance tier:

* each fused stop's dense frame (the decode's per-pixel colours and valid
  mask, and once its camera-frame points for the pinhole fit) is observed
  into a bounded round-robin frame buffer at a fixed fit resolution: one
  strided subsample per stop, taken on the device before the copy to the
  host;
* the splat scene is lazy: seeded from the volume and fitted against the
  buffered frames only when a render is asked for, and only when stops
  arrived since the last build. The build is split in three
  (:meth:`~SplatPreviewMesher.begin_scene_build` — the cheap seed pass,
  :meth:`~SplatPreviewMesher.finish_scene_build` — the fit, on an
  immutable snapshot, :meth:`~SplatPreviewMesher.adopt_scene` — publish,
  newest stops win), as in the JAX package; ``ensure_scene`` composes
  them;
* a rebuild is from scratch (re-seed + fixed-iteration fit), so a render
  is a deterministic function of the volume and the frame buffer, up to
  the order of the fit's gradient sums on the card.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..fusion.preview import TSDFPreviewMesher
from ..io.png import png_bytes
from ..ops import splat_render as sr
from ..ops.tsdf import TSDFParams
from .fit import fit_appearance, fit_pinhole, frame_target
from .model import SplatParams, SplatScene, seed_from_volume

log = logging.getLogger(__name__)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


class _SceneBuild:
    """One in-flight lazy scene rebuild: the seeded scene plus an immutable
    snapshot of the fit inputs."""

    __slots__ = ("scene", "stops", "frames", "cams", "t0", "done")

    def __init__(self, scene, stops, frames, cams, t0, done=False):
        self.scene = scene
        self.stops = stops
        self.frames = frames
        self.cams = cams
        self.t0 = t0
        self.done = done


class SplatPreviewMesher(TSDFPreviewMesher):
    """The ``representation="splat"`` previewer: TSDF mesh previews +
    rendered novel views."""

    def __init__(self, voxel_size_hint: float,
                 params: TSDFParams = TSDFParams(max_bricks=4096),
                 splat_params: SplatParams = SplatParams(),
                 fit_iters: int = 40, max_frames: int = 8,
                 fit_pixels: int = 12288,
                 render_sizes: tuple = ((384, 288),), **kw):
        super().__init__(voxel_size_hint, params=params, **kw)
        self.splat_params = splat_params
        self.fit_iters = int(fit_iters)
        self.max_frames = max(1, int(max_frames))
        self.fit_pixels = int(fit_pixels)
        self.render_sizes = tuple((int(w), int(h))
                                  for w, h in render_sizes)
        self.intrinsics: tuple | None = None   # (fx, fy, cx, cy) full-res
        self.frame_shape: tuple | None = None
        self.stride: int = 1
        self._frames: list = []        # (target, mask) host arrays
        self._cams: list = []          # render camera tuples at fit res
        self._frames_seen = 0
        self._scene: SplatScene | None = None
        self._scene_stops = -1         # stops_integrated at last build
        self.last_render_meta: dict = {}

    # -- frame observation (per fused stop) --------------------------------

    def observe_frame(self, points, colors, valid, pose,
                      frame_shape) -> bool:
        """Buffer one stop's dense frame for the appearance fit.

        ``points``/``colors``/``valid`` are the stop's dense decode arrays
        (camera frame, (H·W, …), tensors or host arrays); ``pose`` the
        stop's camera→model 4×4. Returns False when the frame is unusable
        (pinhole fit failed) — rendering still works from the volume's DC
        colours."""
        h, w = int(frame_shape[0]), int(frame_shape[1])
        if self.frame_shape is None:
            self.frame_shape = (h, w)
            stride = 1
            while (h // stride) * (w // stride) > self.fit_pixels:
                stride += 1
            self.stride = stride
        elif (h, w) != self.frame_shape:
            log.warning("splat frame shape changed %s -> %s; frame "
                        "dropped", self.frame_shape, (h, w))
            return False
        if self.intrinsics is None:
            fit = fit_pinhole(_host(points), _host(valid), h, w)
            if fit is None:
                log.debug("splat pinhole fit abstained (stop too sparse)")
                return False
            self.intrinsics = fit
        # The strided subsample first (on the colours' device), then the
        # copy: frame_target at stride 1 on the subsampled grid is
        # frame_target at the stride on the full one.
        s = self.stride
        sub_c = colors.reshape(h, w, 3)[::s, ::s]
        sub_v = valid.reshape(h, w)[::s, ::s]
        sh, sw = sub_v.shape[:2]
        target, mask = frame_target(_host(sub_c), _host(sub_v), sh, sw, 1)
        fx, fy, cx, cy = self.intrinsics
        sf = float(s)
        cam = sr.stop_camera(np.asarray(pose, np.float64),
                             fx / sf, fy / sf, cx / sf, cy / sf)
        if len(self._frames) < self.max_frames:
            self._frames.append((target, mask))
            self._cams.append(cam)
        else:
            slot = self._frames_seen % self.max_frames
            self._frames[slot] = (target, mask)
            self._cams[slot] = cam
        self._frames_seen += 1
        return True

    # -- lazy scene build --------------------------------------------------

    @property
    def scene_stale(self) -> bool:
        return (self._scene is None or self.volume is None
                or self._scene_stops != self.volume.stops_integrated)

    def begin_scene_build(self) -> "_SceneBuild | None":
        """Phase 1: snapshot the build inputs and run the cheap seed pass.
        None before the first integrated stop; a non-stale scene returns a
        done token (finish/adopt are then no-ops)."""
        if self.volume is None:
            return None
        if not self.scene_stale:
            return _SceneBuild(scene=self._scene,
                               stops=self._scene_stops, frames=(),
                               cams=(), t0=time.monotonic(), done=True)
        t0 = time.monotonic()
        scene = seed_from_volume(self.volume, self.splat_params)
        return _SceneBuild(scene=scene,
                           stops=self.volume.stops_integrated,
                           frames=tuple(self._frames),
                           cams=tuple(self._cams), t0=t0)

    def finish_scene_build(self, token: "_SceneBuild") -> "_SceneBuild":
        """Phase 2: the fixed-iteration appearance fit on the token's
        snapshot."""
        if token.done:
            return token
        if token.frames and token.scene.n_splats:
            # The buffer padded to the fixed max_frames slot count by
            # cycling what exists (duplicate supervision ≈ extra epochs on
            # fewer frames), as in the JAX package.
            idx = [i % len(token.frames)
                   for i in range(self.max_frames)]
            frames = np.stack([token.frames[i][0] for i in idx])
            masks = np.stack([token.frames[i][1] for i in idx])
            fit_appearance(token.scene, frames, masks,
                           [token.cams[i] for i in idx],
                           iters=self.fit_iters)
        token.scene.fit_stats["build_seconds"] = round(
            time.monotonic() - token.t0, 3)
        token.done = True
        return token

    def adopt_scene(self, token: "_SceneBuild") -> SplatScene:
        """Phase 3: publish the built scene; a build that fused more stops
        keeps its (fresher) scene. Returns the token's own scene."""
        if self._scene is None or self._scene_stops <= token.stops:
            self._scene = token.scene
            self._scene_stops = token.stops
        return token.scene

    def ensure_scene(self) -> SplatScene | None:
        """Seed + fit if stops arrived since the last build; None before
        the first integrated stop."""
        token = self.begin_scene_build()
        if token is None:
            return None
        self.finish_scene_build(token)
        return self.adopt_scene(token)

    # -- rendering ---------------------------------------------------------

    def render_size_ok(self, width: int, height: int) -> bool:
        return (int(width), int(height)) in self.render_sizes

    def render_image(self, azim: float, elev: float,
                     width: int | None = None,
                     height: int | None = None,
                     scene: "SplatScene | None" = None
                     ) -> np.ndarray | None:
        """(H, W, 3) uint8 novel view, or None before the first stop.
        ``scene`` renders a pre-built scene instead of calling
        ``ensure_scene``."""
        if scene is None:
            scene = self.ensure_scene()
        if scene is None:
            return None
        w, h = self.render_sizes[0]
        if width is not None and height is not None:
            w, h = int(width), int(height)
        t0 = time.monotonic()
        img = scene.render(azim=float(azim), elev=float(elev),
                           width=w, height=h)
        self.last_render_meta = {
            "azim": round(float(azim), 3), "elev": round(float(elev), 3),
            "width": w, "height": h, "splats": scene.n_splats,
            "render_s": round(time.monotonic() - t0, 4),
            "fit_frames": len(self._frames),
        }
        return img

    def render_png(self, azim: float, elev: float,
                   width: int | None = None,
                   height: int | None = None,
                   scene: "SplatScene | None" = None
                   ) -> tuple[bytes, dict] | None:
        img = self.render_image(azim, elev, width, height, scene=scene)
        if img is None:
            return None
        return png_bytes(img), dict(self.last_render_meta)

    def scene_bytes(self, scene: "SplatScene | None" = None
                    ) -> bytes | None:
        """The current scene as .npz bytes (the JAX package's schema)."""
        if scene is None:
            scene = self.ensure_scene()
        return None if scene is None else scene.to_bytes()

    def stats(self) -> dict:
        out = super().stats()
        out.update(fit_frames=len(self._frames),
                   frames_seen=self._frames_seen,
                   scene_stale=self.scene_stale)
        if self._scene is not None:
            out.update(self._scene.stats())
        return out
