"""Marching-tets classify pass (counterpart of the JAX
``ops/marching_pallas.py`` and of the corner frame built before it in
``marching_jax._phase_corners``): from (M, 512) bricks and their
8-neighbour table, the (M, 729) corner frame — the 9³ corners of each 8³
brick, flat (x·9 + y)·9 + z — and the (M, 512) mask of cells whose 8
corners are neither all inside (``> iso``) nor all outside, on valid
bricks, with its count.

On a CUDA tensor :func:`classify_bricks` launches the hand-written kernel
``csrc/classify.cu``, which builds the frame and classifies it in one pass;
on a CPU tensor it takes the plain version :func:`classify_bricks_reference`
(:func:`corner_frame_reference`, then :func:`classify_cells_reference`, the
XLA branch of the JAX package's ``_phase_corners``). The frame is copied
values and the mask boolean, so the two agree bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

# Cube corner offsets in the order of ``marching._CORNERS``.
_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], dtype=np.int64)
BS = 8
_C9 = BS + 1  # corner frame edge: 8 voxels + the +face plane
_V = BS ** 3  # cells per brick

# Cell c at (cx, cy, cz), corner j reads frame position
# ((cx+dx)·9 + (cy+dy))·9 + (cz+dz).
_CELL = np.arange(_V)
_CIDX = (((_CELL[:, None] // 64 + _CORNERS[None, :, 0]) * _C9
          + (_CELL[:, None] // 8) % 8 + _CORNERS[None, :, 1]) * _C9
         + _CELL[:, None] % 8 + _CORNERS[None, :, 2])

# Corner frame source maps: corner position (x, y, z) ∈ [0, 8]³ reads from
# the neighbour selected by which coordinates hit 8 (the +face), at the
# wrapped voxel, falling back to the own-brick clamp voxel when that
# neighbour is absent. The neighbour columns of an nb8 table:
_NB_ORDER = {(0, 0, 0): 0, (1, 0, 0): 1, (0, 1, 0): 2, (0, 0, 1): 3,
             (1, 1, 0): 4, (1, 0, 1): 5, (0, 1, 1): 6, (1, 1, 1): 7}


def _corner_maps():
    x, y, z = np.meshgrid(np.arange(_C9), np.arange(_C9), np.arange(_C9),
                          indexing="ij")
    x, y, z = x.reshape(-1), y.reshape(-1), z.reshape(-1)
    case = np.array([_NB_ORDER[(int(a == BS), int(b == BS), int(c == BS))]
                     for a, b, c in zip(x, y, z)], np.int64)
    src = ((x % BS) * BS + (y % BS)) * BS + (z % BS)
    clamp = ((np.minimum(x, BS - 1) * BS + np.minimum(y, BS - 1)) * BS
             + np.minimum(z, BS - 1))
    return case, src.astype(np.int64), clamp.astype(np.int64)


_CASE9, _SRC9, _CLAMP9 = _corner_maps()


def _t(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(a).to(dev)


def _iso_tensor(iso, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(iso, dtype=torch.float32,
                           device=like.device).reshape(())


def corner_frame_reference(chi: torch.Tensor,
                           nb8: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the frame: (M, 512) bricks + (M, 8) table
    [own, +x, +y, +z, +xy, +xz, +yz, +xyz] with entries in [0, M] (M =
    absent) → (M, 729) corner frame, each +face read from its neighbour and
    clamped to the own face where the neighbour is absent."""
    m = chi.shape[0]
    dev = chi.device
    rows = nb8[:, _t(_CASE9, dev)]                              # (M, 729)
    chi_pad = torch.cat([chi, chi.new_zeros((1, _V))])
    vals = chi_pad.reshape(-1)[rows * _V + _t(_SRC9, dev)]
    return torch.where(rows < m, vals, chi[:, _t(_CLAMP9, dev)])


def classify_cells_reference(c9: torch.Tensor, iso,
                             block_valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the classify half: ``inside = c9 > iso``,
    any/all over the 8 corner gathers, ``any & ~all & block_valid``."""
    inside = c9 > _iso_tensor(iso, c9)
    cidx = torch.from_numpy(_CIDX).to(c9.device)
    any_in = all_in = None
    for j in range(8):
        blk = inside[:, cidx[:, j]]
        any_in = blk if any_in is None else (any_in | blk)
        all_in = blk if all_in is None else (all_in & blk)
    return any_in & ~all_in & block_valid[:, None]


def classify_bricks_reference(chi: torch.Tensor, nb8: torch.Tensor, iso,
                              block_valid: torch.Tensor):
    """Plain PyTorch version of :func:`classify_bricks`."""
    c9 = corner_frame_reference(chi, nb8)
    active = classify_cells_reference(c9, iso, block_valid)
    return c9, active, active.sum(dtype=torch.int32)


def classify_bricks(chi: torch.Tensor, nb8: torch.Tensor, iso,
                    block_valid: torch.Tensor):
    """(M, 512) float32 bricks, (M, 8) int64 neighbour table (column 0 the
    brick's own slot, as ``marching_device._nb8_table`` gives it; M =
    absent), iso (0-d tensor or float), (M,) bool → (c9 (M, 729) float32,
    active (M, 512) bool, count () int32).

    A CUDA tensor launches ``sl_classify_bricks`` (``csrc/classify.cu``)
    once and raises if it cannot; only a CPU tensor takes
    :func:`classify_bricks_reference`."""
    m = chi.shape[0]
    if (chi.dim() != 2 or chi.shape[1] != _V or nb8.shape != (m, 8)
            or block_valid.shape != (m,)):
        raise ValueError(f"classify_bricks takes chi (M, 512), nb8 (M, 8) "
                         f"and block_valid (M,); got {tuple(chi.shape)}, "
                         f"{tuple(nb8.shape)}, {tuple(block_valid.shape)}")
    if (chi.dtype != torch.float32 or nb8.dtype != torch.int64
            or block_valid.dtype != torch.bool):
        raise ValueError(f"classify_bricks takes float32 chi, int64 nb8 and "
                         f"bool block_valid; got {chi.dtype}, {nb8.dtype}, "
                         f"{block_valid.dtype}")
    if nb8.device != chi.device or block_valid.device != chi.device:
        raise ValueError(f"classify_bricks: chi is on {chi.device}, nb8 on "
                         f"{nb8.device}, block_valid on {block_valid.device}")
    if chi.device.type == "cpu":
        return classify_bricks_reference(chi, nb8, iso, block_valid)
    if chi.device.type != "cuda":
        raise ValueError(f"classify_bricks has no kernel for {chi.device}")
    if not (chi.is_contiguous() and nb8.is_contiguous()
            and block_valid.is_contiguous()):
        raise ValueError("classify_bricks needs contiguous operands")
    if chi.data_ptr() % 16:
        raise ValueError("classify_bricks needs chi 16-byte aligned (its "
                         "rows are copied 16 bytes at a time)")
    from ..kernels import build

    lib = build.library()
    iso_t = _iso_tensor(iso, chi).contiguous()
    c9 = torch.empty((m, _C9 ** 3), dtype=torch.float32, device=chi.device)
    active = torch.empty((m, _V), dtype=torch.bool, device=chi.device)
    count = torch.empty((), dtype=torch.int32, device=chi.device)
    with torch.cuda.device(chi.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sl_classify_bricks(
            chi.data_ptr(), nb8.data_ptr(), iso_t.data_ptr(),
            block_valid.data_ptr(), c9.data_ptr(), active.data_ptr(),
            count.data_ptr(), m, stream)
    build.check(err, "sl_classify_bricks")
    classify_bricks.launches += 1
    return c9, active, count


classify_bricks.launches = 0
