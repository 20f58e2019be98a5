"""Streaming incremental reconstruction (counterpart of the JAX ``stream/``
package): each stop of a 360° scan is decoded, registered against the last,
fused into a running model and a TSDF volume, and previewed as it lands;
``finalize`` closes the ring and builds the final mesh.

Entry point: :class:`~.session.IncrementalSession` (``add_stop`` ×N →
``finalize()``). :func:`~.warmup.warm_session_programs` runs the session
lane once on synthetic stops before a serving replica takes sessions.
"""

from .preview import PreviewMesher, make_previewer
from .session import (
    FinalizeResult,
    IncrementalSession,
    StopResult,
    StreamParams,
    voxel_overlap,
)
from .warmup import warm_session_programs


__all__ = [
    "FinalizeResult",
    "IncrementalSession",
    "PreviewMesher",
    "StopResult",
    "StreamParams",
    "make_previewer",
    "voxel_overlap",
    "warm_session_programs",
]
