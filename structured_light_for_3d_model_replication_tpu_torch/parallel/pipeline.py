"""Sharded batch reconstruction: scans over ``data``, camera rows over
``space`` (counterpart of the JAX package's ``parallel/pipeline.py``).

The JAX package places the batch with a ``NamedSharding``, jits the batch
function and lets GSPMD insert its one collective: the adaptive mask's
per-image statistics. Here that collective is written out. Each member
runs two steps on its own block, on its own device:

1. :func:`member_decode` — the ``decode_maps`` kernel on the block, the
   block's 256-bin ``uint8`` histogram of the black frame and its maximum
   contrast, one of each per scan;
2. :func:`member_finish` — the mask against the scan's thresholds, then
   triangulation of the block's rows with the calibration indexed at the
   block's global row offset.

Between them the counts are summed and the maxima reduced over the members
of one ``data`` row (never across scans: the percentile is per image), in
member order on the row's first member. Integer counts and a maximum do not
depend on that order, so the result is bit-equal to the unsharded
``models/pipeline.reconstruct_batch``. Each step is a function of (its
block, its device, its row offset), so a caller with one card can run every
member's step in turn on it (``chip_smoke.py``).
"""

from __future__ import annotations

import torch

from ..config import DecodeConfig, TriangulationConfig
from ..models.pipeline import CloudResult
from ..ops import decode as decode_ops
from ..ops import triangulate as tri_ops
from . import mesh as mesh_lib


def shard_inputs(stacks, calib: tri_ops.Calibration, mesh: mesh_lib.Mesh):
    """Place a (B, F, H, W) batch on the mesh — scans over ``data``, rows
    over ``space`` — and a copy of the calibration on every member:
    (``blocks[d][s]``, ``calibs[d][s]``)."""
    blocks = mesh_lib.split_batch(stacks, mesh)
    calibs = [[calib.to(d) for d in row] for row in mesh.devices]
    return blocks, calibs


def member_decode(block: torch.Tensor, col_bits: int, row_bits: int,
                  downsample: int = 1):
    """Step 1 on one member's (b, F, h, W) uint8 block, on the block's
    device: (col_map, row_map) (b, h, W) int32, the black frame's (b, 256)
    int64 histogram counts and the (b,) float32 maximum contrast."""
    col_map, row_map = decode_ops.decode_maps(block, col_bits, row_bits,
                                              downsample)
    white = block[:, 0].to(torch.float32)
    black = block[:, 1]
    contrast = white - black.to(torch.float32)
    return (col_map, row_map, decode_ops.u8_counts(black),
            contrast.amax(dim=(-2, -1)))


def member_finish(block: torch.Tensor, col_map: torch.Tensor,
                  row_map: torch.Tensor, thresholds, calib, row0: int,
                  decode_cfg: DecodeConfig = DecodeConfig(),
                  tri_cfg: TriangulationConfig = TriangulationConfig()
                  ) -> CloudResult:
    """Step 2 on one member: mask the block (against the scan's reduced
    ``(thresh_w, thresh_c)`` in ``"adaptive"`` mode; ``thresholds`` is
    unused in ``"fixed"`` mode) and triangulate its rows with the camera
    rays from global row ``row0`` on."""
    white, black = block[:, 0], block[:, 1]
    if decode_cfg.mode == "adaptive":
        thresh_w, thresh_c = thresholds
        w = white.to(torch.float32)
        mask = decode_ops.masked_by_thresholds(
            w, w - black.to(torch.float32), thresh_w, thresh_c)
    elif decode_cfg.mode == "fixed":
        mask = decode_ops.fixed_mask(white, black, decode_cfg.white_thresh,
                                     decode_cfg.contrast_thresh)
    else:
        raise ValueError(f"unknown mask mode {decode_cfg.mode!r}")
    h = block.shape[2]
    rows = calib._replace(Nc=calib.Nc[row0:row0 + h])
    points, valid = tri_ops.triangulate(col_map, row_map, mask, rows,
                                        cfg=tri_cfg)
    colors = tri_ops.colors_from_white(white, batch_dims=1)
    return CloudResult(points, colors, valid, col_map, row_map)


def reduce_thresholds(counts, maxima, n_pixels: int, device,
                      decode_cfg: DecodeConfig = DecodeConfig()):
    """One data row's members' (counts, maxima) → the scans' (thresh_w,
    thresh_c) on ``device``: counts summed and maxima reduced in member
    order, then the reference's thresholds (``ops/decode.adaptive_mask``)
    on images of ``n_pixels``."""
    total = counts[0].to(device)
    top = maxima[0].to(device)
    for c, m in zip(counts[1:], maxima[1:]):
        total = total + c.to(device)
        top = torch.maximum(top, m.to(device))
    p = decode_ops.percentile_from_counts(total, n_pixels,
                                          decode_cfg.black_percentile)
    return decode_cfg.white_factor * p, decode_cfg.contrast_frac * top


def reconstruct_blocks(blocks, calibs, col_bits: int, row_bits: int,
                       decode_cfg: DecodeConfig = DecodeConfig(),
                       tri_cfg: TriangulationConfig = TriangulationConfig(),
                       downsample: int = 1, out_device=None) -> CloudResult:
    """Decode + triangulate placed blocks (``blocks[d][s]`` on their
    members, ``calibs[d][s]`` beside them) and gather the batched
    CloudResult on ``out_device`` (None = the first member's device), in
    member order. Empty blocks (an uneven split) take no step."""
    rows_out = []
    for row_blocks, row_calibs in zip(blocks, calibs):
        live = [(blk, cal) for blk, cal in zip(row_blocks, row_calibs)
                if blk.shape[0] and blk.shape[2]]
        if not live:
            continue
        steps = [member_decode(blk, col_bits, row_bits, downsample)
                 for blk, _ in live]
        thresholds = [None] * len(live)
        if decode_cfg.mode == "adaptive":
            head = live[0][0].device
            n_pixels = sum(blk.shape[2] for blk, _ in live) \
                * live[0][0].shape[3]
            tw, tc = reduce_thresholds([s[2] for s in steps],
                                       [s[3] for s in steps], n_pixels,
                                       head, decode_cfg)
            thresholds = [(tw.to(blk.device), tc.to(blk.device))
                          for blk, _ in live]
        parts, row0 = [], 0
        for (blk, cal), step, th in zip(live, steps, thresholds):
            parts.append(member_finish(blk, step[0], step[1], th, cal, row0,
                                       decode_cfg, tri_cfg))
            row0 += blk.shape[2]
        rows_out.append(parts)
    if out_device is None:
        out_device = rows_out[0][0].points.device
    # Every field's pixel or row axis is axis 1: members' blocks join
    # there, data rows on axis 0.
    return CloudResult(*(
        torch.cat([mesh_lib.gather_rows([getattr(p, f) for p in parts], 1,
                                        out_device)
                   for parts in rows_out], 0)
        for f in CloudResult._fields))


def reconstruct_sharded(
    stacks,
    calib: tri_ops.Calibration,
    mesh: mesh_lib.Mesh,
    col_bits: int,
    row_bits: int,
    decode_cfg: DecodeConfig = DecodeConfig(),
    tri_cfg: TriangulationConfig = TriangulationConfig(),
    downsample: int = 1,
    out_device=None,
) -> CloudResult:
    """Decode + triangulate a (B, F, H, W) batch across the mesh: B over
    ``data``, rows over ``space`` in ``ceil(H / space)`` blocks (the last
    ones shorter, as GSPMD pads). Returns the batched CloudResult gathered
    on ``out_device`` (None = the mesh's first member), bit-equal to
    ``models/pipeline.reconstruct_batch`` on the same inputs."""
    if stacks.ndim != 4:
        raise ValueError(f"stacks must be (B, F, H, W), got "
                         f"{tuple(stacks.shape)}")
    blocks, calibs = shard_inputs(stacks, calib, mesh)
    return reconstruct_blocks(blocks, calibs, col_bits, row_bits,
                              decode_cfg, tri_cfg, downsample, out_device)
