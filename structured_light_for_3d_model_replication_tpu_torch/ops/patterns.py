"""Gray-code pattern generation (counterpart of the JAX ``ops/patterns.py``).

Frame protocol: frame 0 = white, frame 1 = black, then for each column bit
MSB-first a (pattern, inverse) pair, then the same for row bits.
1920x1080 => 46 frames.
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from ..config import ProjectorConfig


def gray_code(x: torch.Tensor) -> torch.Tensor:
    """Binary-reflected Gray code of an integer tensor."""
    return x ^ (x >> 1)


def gray_to_binary(g: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Inverse of :func:`gray_code` by doubling XOR shifts."""
    b = g
    shift = 1
    while shift < n_bits:
        b = b ^ (b >> shift)
        shift *= 2
    return b


def bit_planes(n: int, n_bits: int, downsample: int = 1,
               device=None) -> torch.Tensor:
    """(n_bits, n) uint8: Gray-code bit b (MSB-first) of each COARSE index."""
    dev = resolve_device(device)
    idx = torch.arange(n, dtype=torch.int32, device=dev) // downsample
    g = gray_code(idx)
    shifts = torch.arange(n_bits - 1, -1, -1, dtype=torch.int32,
                          device=dev)[:, None]
    return ((g[None, :] >> shifts) & 1).to(torch.uint8)


def pattern_stack(width: int, height: int, col_bits: int, row_bits: int,
                  brightness: int = 200, downsample: int = 1,
                  device=None) -> torch.Tensor:
    """Full projector frame stack, (n_frames, height, width) uint8.

    Layout: [white, black, colbit0, ~colbit0, ..., rowbit0, ~rowbit0, ...].
    """
    dev = resolve_device(device)
    b = brightness
    white = torch.full((1, height, width), b, dtype=torch.uint8, device=dev)
    black = torch.zeros((1, height, width), dtype=torch.uint8, device=dev)

    cols = bit_planes(width, col_bits, downsample, dev)          # (cb, W)
    col_pat = (cols[:, None, None, :] * b).expand(col_bits, 1, height, width)
    col_frames = torch.cat([col_pat, b - col_pat], dim=1).reshape(
        2 * col_bits, height, width)

    rows = bit_planes(height, row_bits, downsample, dev)         # (rb, H)
    row_pat = (rows[:, None, :, None] * b).expand(row_bits, 1, height, width)
    row_frames = torch.cat([row_pat, b - row_pat], dim=1).reshape(
        2 * row_bits, height, width)
    return torch.cat([white, black, col_frames, row_frames], dim=0)


def pattern_stack_for(proj: ProjectorConfig, device=None) -> torch.Tensor:
    return pattern_stack(proj.width, proj.height, proj.col_bits,
                         proj.row_bits, proj.brightness, proj.downsample,
                         device=device)
