"""Marching-tets active-cell classification (counterpart of the JAX
``ops/marching_pallas.py``): from a (M, 729) corner frame — the 9³ corners
of each 8³ brick, flat (x·9 + y)·9 + z — and the iso level, the (M, 512)
mask of cells whose 8 corners are neither all inside (``> iso``) nor all
outside, on valid bricks.

On a CUDA tensor :func:`classify_cells` launches the hand-written kernel
``csrc/classify.cu``; on a CPU tensor it takes the plain version
:func:`classify_cells_reference`, the XLA branch of the JAX package's
``marching_jax._phase_corners``. The result is boolean, so the two agree
exactly.
"""

from __future__ import annotations

import numpy as np
import torch

# Cube corner offsets in the order of ``marching._CORNERS``.
_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], dtype=np.int64)
_C9 = 9      # corner frame edge: 8 voxels + the +face plane
_V = 512     # cells per brick

# Cell c at (cx, cy, cz), corner j reads frame position
# ((cx+dx)·9 + (cy+dy))·9 + (cz+dz).
_CELL = np.arange(_V)
_CIDX = (((_CELL[:, None] // 64 + _CORNERS[None, :, 0]) * _C9
          + (_CELL[:, None] // 8) % 8 + _CORNERS[None, :, 1]) * _C9
         + _CELL[:, None] % 8 + _CORNERS[None, :, 2])


def _iso_tensor(iso, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(iso, dtype=torch.float32,
                           device=like.device).reshape(())


def classify_cells_reference(c9: torch.Tensor, iso,
                             block_valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``inside = c9 > iso``, any/all over the 8
    corner gathers, ``any & ~all & block_valid``."""
    inside = c9 > _iso_tensor(iso, c9)
    cidx = torch.from_numpy(_CIDX).to(c9.device)
    any_in = all_in = None
    for j in range(8):
        blk = inside[:, cidx[:, j]]
        any_in = blk if any_in is None else (any_in | blk)
        all_in = blk if all_in is None else (all_in & blk)
    return any_in & ~all_in & block_valid[:, None]


def classify_cells(c9: torch.Tensor, iso,
                   block_valid: torch.Tensor) -> torch.Tensor:
    """(M, 729) float32 corner frame, iso (0-d tensor or float), (M,) bool
    → active (M, 512) bool.

    A CUDA tensor launches ``sl_classify_cells`` (``csrc/classify.cu``) and
    raises if it cannot; only a CPU tensor takes
    :func:`classify_cells_reference`."""
    m = c9.shape[0]
    if c9.dim() != 2 or c9.shape[1] != _C9 ** 3 or block_valid.shape != (m,):
        raise ValueError(f"classify_cells takes c9 (M, 729) and block_valid "
                         f"(M,); got {tuple(c9.shape)}, "
                         f"{tuple(block_valid.shape)}")
    if c9.dtype != torch.float32 or block_valid.dtype != torch.bool:
        raise ValueError(f"classify_cells takes float32 c9 and bool "
                         f"block_valid; got {c9.dtype}, {block_valid.dtype}")
    if block_valid.device != c9.device:
        raise ValueError(f"classify_cells: block_valid is on "
                         f"{block_valid.device}, c9 on {c9.device}")
    if c9.device.type == "cpu":
        return classify_cells_reference(c9, iso, block_valid)
    if c9.device.type != "cuda":
        raise ValueError(f"classify_cells has no kernel for {c9.device}")
    if not (c9.is_contiguous() and block_valid.is_contiguous()):
        raise ValueError("classify_cells needs contiguous operands")
    from ..kernels import build

    lib = build.library()
    iso_t = _iso_tensor(iso, c9).contiguous()
    active = torch.empty((m, _V), dtype=torch.bool, device=c9.device)
    with torch.cuda.device(c9.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sl_classify_cells(c9.data_ptr(), iso_t.data_ptr(),
                                    block_valid.data_ptr(),
                                    active.data_ptr(), m, stream)
    build.check(err, "sl_classify_cells")
    classify_cells.launches += 1
    return active


classify_cells.launches = 0
