"""The single-scan pipeline: stack → decode → triangulate → colors
(counterpart of the JAX ``models/pipeline.py``).

Outputs are dense over all H·W pixels with a `valid` mask, never gathered.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..config import DecodeConfig, TriangulationConfig
from ..ops import decode as decode_ops
from ..ops import triangulate as tri_ops


class CloudResult(NamedTuple):
    points: torch.Tensor   # (..., H*W, 3) float32, zeros where invalid
    colors: torch.Tensor   # (..., H*W, 3) uint8 from the white reference frame
    valid: torch.Tensor    # (..., H*W) bool
    col_map: torch.Tensor  # (..., H, W) int32 decoded projector column
    row_map: torch.Tensor  # (..., H, W) int32 decoded projector row


def reconstruct_batch(stacks, calib: tri_ops.Calibration, col_bits: int,
                      row_bits: int,
                      decode_cfg: DecodeConfig = DecodeConfig(),
                      tri_cfg: TriangulationConfig = TriangulationConfig(),
                      downsample: int = 1, device=None) -> CloudResult:
    """(B, F, H, W) uint8 stacks (host array or tensor) + shared calibration
    → CloudResult batched on the leading axis. The decode kernel runs once
    for the whole batch."""
    dev = resolve_device(device)
    if isinstance(stacks, np.ndarray):
        stacks = torch.from_numpy(stacks)
    stacks = stacks.to(dev).contiguous()
    if calib.Nc.device != dev:
        calib = calib.to(dev)
    if stacks.dim() != 4:
        raise ValueError(f"stacks must be (B, F, H, W), got "
                         f"{tuple(stacks.shape)}")
    col_map, row_map, mask = decode_ops.decode_stack(
        stacks, col_bits, row_bits, cfg=decode_cfg, downsample=downsample)
    points, valid = tri_ops.triangulate(col_map, row_map, mask, calib,
                                        cfg=tri_cfg)
    colors = tri_ops.colors_from_white(stacks[:, 0], batch_dims=1)
    return CloudResult(points, colors, valid, col_map, row_map)


def reconstruct(stack, calib: tri_ops.Calibration, col_bits: int,
                row_bits: int,
                decode_cfg: DecodeConfig = DecodeConfig(),
                tri_cfg: TriangulationConfig = TriangulationConfig(),
                downsample: int = 1, device=None) -> CloudResult:
    """Full scan→cloud step for one (F, H, W) stack (the reference's
    decode+triangulate core, `server/sl_system.py:508-653`)."""
    if stack.ndim != 3:
        raise ValueError(f"stack must be (F, H, W), got {tuple(stack.shape)}")
    res = reconstruct_batch(stack[None], calib, col_bits, row_bits,
                            decode_cfg, tri_cfg, downsample, device)
    return CloudResult(*(a[0] for a in res))


def to_point_cloud(res: CloudResult):
    """Compact a single-scan CloudResult to a host PointCloud."""
    from ..io.ply import PointCloud

    keep = res.valid.cpu().numpy()
    return PointCloud(points=res.points.cpu().numpy()[keep],
                      colors=res.colors.cpu().numpy()[keep])
