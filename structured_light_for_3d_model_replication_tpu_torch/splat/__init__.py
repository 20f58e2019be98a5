"""splat/ — the Gaussian appearance tier on the fused TSDF shell
(counterpart of the JAX ``splat/`` package).

Anisotropic Gaussians SEEDED on the TSDF iso-shell that ``fusion/``
maintains, FITTED against the per-stop RGB the capture already produced
(degree-1 SH colour, opacity and scale; Adam through the plain composite),
and RENDERED from any novel view by the tile-binned sorted alpha composite
(``ops/splat_render.py``, the CUDA kernel ``csrc/composite.cu`` on the
card). Positions and normals come from the volume and are never optimized.

Entry points: :func:`splat_scene_from_cloud` (cloud → scene),
:func:`seed_from_volume` (streaming / fusion path), :class:`SplatScene`
(render / save / load, the JAX package's npz schema) and
:class:`SplatPreviewMesher` (the streaming previewer lane).
"""

from .fit import fit_appearance, fit_pinhole, psnr
from .model import (
    SplatParams,
    SplatScene,
    seed_from_volume,
    splat_scene_from_cloud,
)
from .preview import SplatPreviewMesher

__all__ = [
    "SplatParams",
    "SplatPreviewMesher",
    "SplatScene",
    "fit_appearance",
    "fit_pinhole",
    "psnr",
    "seed_from_volume",
    "splat_scene_from_cloud",
]
