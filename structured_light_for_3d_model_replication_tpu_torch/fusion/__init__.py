"""fusion/ — the fused TSDF scene representation (counterpart of the JAX
``fusion/`` package): a sparse brick-grid truncated-signed-distance volume
fused incrementally on the device (:mod:`..ops.tsdf`, whose running-average
combine is the CUDA kernel ``csrc/combine.cu`` on the card), extracted as a
vertex-coloured mesh through the port's device marching machinery
(:mod:`.extract`). Unobserved space extracts as nothing, so open scenes stay
open; per-point colour survives into the mesh.

Entry points: :class:`TSDFVolume`, ``models.meshing.mesh_from_cloud(
representation="tsdf")`` and the streaming session's default
``representation="tsdf"`` (:class:`TSDFPreviewMesher`).
"""

from ..ops.tsdf import TSDFParams, TSDFState, integrate_oracle
from .extract import extract_colored
from .preview import TSDFPreviewMesher
from .volume import TSDFVolume, fit_bounds

__all__ = [
    "TSDFParams",
    "TSDFState",
    "TSDFPreviewMesher",
    "TSDFVolume",
    "extract_colored",
    "fit_bounds",
    "integrate_oracle",
]
