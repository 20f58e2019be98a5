"""Streaming incremental reconstruction (counterpart of the JAX ``stream/``
package): each stop of a 360° scan is decoded, registered against the last,
fused into a running model and a TSDF volume, and previewed as it lands;
``finalize`` closes the ring and builds the final mesh.

Entry point: :class:`~.session.IncrementalSession` (``add_stop`` ×N →
``finalize()``). ``warm_session_programs`` (the JAX package's jit-cache
warm-up before a serving session) is not ported yet.
"""

from ..ops.poisson_sparse import _not_ported
from .preview import PreviewMesher, make_previewer
from .session import (
    FinalizeResult,
    IncrementalSession,
    StopResult,
    StreamParams,
    voxel_overlap,
)


def warm_session_programs(*args, **kwargs):
    """The JAX package's session warm-up; in the port its job would be
    building the kernels and priming cuBLAS/cuSOLVER before a session."""
    raise _not_ported("stream.warm_session_programs",
                      "step 8 (devices, serving, tools)")


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
