"""Per-pixel Gray-code stack decode (counterpart of the JAX ``ops/decode.py``
and of its TPU kernel ``ops/decode_pallas.py``).

Stack layout is the protocol order of ``patterns.pattern_stack``:
[white, black, colbit_0, ~colbit_0, ..., rowbit_0, ~rowbit_0, ...], MSB first.

The bit-unpack — the 22-plane reduction that is ~95% of the decode's memory
traffic — is :func:`decode_maps`: on a CUDA tensor the hand-written kernel
``csrc/decode.cu``, on a CPU tensor its plain version
:func:`decode_maps_reference`. The validity mask is two element-wise
compares against data-dependent scalars and stays in PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DecodeConfig
from .patterns import gray_to_binary


def _check_frames(n_frames: int, col_bits: int, row_bits: int) -> int:
    n = 2 + 2 * col_bits + 2 * row_bits
    if n_frames != n:
        raise ValueError(f"stack has {n_frames} frames, expected {n}")
    return n


def split_stack(stack: torch.Tensor, col_bits: int, row_bits: int):
    """Split a protocol-ordered (F, H, W) stack into (white, black,
    col_pairs, row_pairs); the pairs are (n_bits, 2, H, W) with
    [:, 0] = pattern and [:, 1] = inverse."""
    _check_frames(stack.shape[0], col_bits, row_bits)
    rest = stack.shape[1:]
    col = stack[2:2 + 2 * col_bits].reshape(col_bits, 2, *rest)
    row = stack[2 + 2 * col_bits:].reshape(row_bits, 2, *rest)
    return stack[0], stack[1], col, row


def decode_bits(pairs: torch.Tensor) -> torch.Tensor:
    """(n_bits, 2, ...) pattern/inverse pairs -> (...) int32 binary code:
    bit_b = pattern_b > inverse_b, packed MSB-first, then Gray -> binary."""
    n_bits = pairs.shape[0]
    bits = (pairs[:, 0] > pairs[:, 1]).to(torch.int32)
    weights = torch.tensor([1 << (n_bits - 1 - b) for b in range(n_bits)],
                           dtype=torch.int32, device=pairs.device)
    gray = (weights.reshape((n_bits,) + (1,) * (bits.dim() - 1))
            * bits).sum(0, dtype=torch.int32)
    return gray_to_binary(gray, n_bits)


def decode_maps_reference(stacks: torch.Tensor, col_bits: int,
                          row_bits: int, downsample: int = 1):
    """Plain PyTorch version of the decode kernel: (B, F, H, W) uint8 ->
    (col_map, row_map), each (B, H, W) int32 — exactly
    ``decode_bits(...) * ds + (ds - 1) // 2`` per image."""
    _check_frames(stacks.shape[1], col_bits, row_bits)

    def unpack(first: int, n_bits: int) -> torch.Tensor:
        gray = torch.zeros(stacks.shape[:1] + stacks.shape[2:],
                           dtype=torch.int32, device=stacks.device)
        for b in range(n_bits):
            bit = stacks[:, first + 2 * b] > stacks[:, first + 2 * b + 1]
            gray = gray | (bit.to(torch.int32) << (n_bits - 1 - b))
        return (gray_to_binary(gray, n_bits) * downsample
                + (downsample - 1) // 2)

    return unpack(2, col_bits), unpack(2 + 2 * col_bits, row_bits)


def decode_maps(stacks: torch.Tensor, col_bits: int, row_bits: int,
                downsample: int = 1):
    """(B, F, H, W) uint8 -> (col_map, row_map) (B, H, W) int32.

    A CUDA tensor launches the ``sl_decode_maps`` kernel (``csrc/decode.cu``)
    and raises if it cannot; only a CPU tensor takes
    :func:`decode_maps_reference`."""
    if stacks.dim() != 4 or stacks.dtype != torch.uint8:
        raise ValueError(f"decode_maps takes a (B, F, H, W) uint8 tensor, "
                         f"got {tuple(stacks.shape)} {stacks.dtype}")
    _check_frames(stacks.shape[1], col_bits, row_bits)
    if downsample < 1:
        raise ValueError(f"downsample must be >= 1, got {downsample}")
    if stacks.device.type == "cpu":
        return decode_maps_reference(stacks, col_bits, row_bits, downsample)
    if stacks.device.type != "cuda":
        raise ValueError(f"decode_maps has no kernel for {stacks.device}")
    if not stacks.is_contiguous():
        raise ValueError("decode_maps needs a contiguous stack")
    from ..kernels import build

    lib = build.library()
    b, f, h, w = stacks.shape
    col = torch.empty((b, h, w), dtype=torch.int32, device=stacks.device)
    row = torch.empty((b, h, w), dtype=torch.int32, device=stacks.device)
    with torch.cuda.device(stacks.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sl_decode_maps(stacks.data_ptr(), col.data_ptr(),
                                 row.data_ptr(), b, f, h, w, col_bits,
                                 row_bits, downsample, stream)
    build.check(err, "sl_decode_maps")
    decode_maps.launches += 1
    return col, row


decode_maps.launches = 0


def u8_counts(x: torch.Tensor) -> torch.Tensor:
    """256-bin histogram counts of uint8 images: (..., H, W) -> (P, 256)
    int64, one row per image (P = the product of the leading axes).
    Counts of row blocks of an image add up to the image's counts in any
    order, which is what lets a row-sharded decode reduce them exactly
    (:mod:`..parallel.pipeline`)."""
    flat = x.reshape(-1, x.shape[-2] * x.shape[-1])
    b = flat.shape[0]
    offs = torch.arange(b, device=x.device, dtype=torch.int64)[:, None] * 256
    counts = torch.zeros(b * 256, dtype=torch.int64, device=x.device)
    idx = (flat.to(torch.int64) + offs).reshape(-1)
    # torchlint: disable=atomic-scatter -- int64 counts repeat in any order
    counts.scatter_add_(0, idx, torch.ones_like(idx))
    return counts.reshape(b, 256)


def percentile_from_counts(counts: torch.Tensor, n: int,
                           q: float) -> torch.Tensor:
    """Exact linear-interpolation percentile from (P, 256) counts of images
    of ``n`` pixels each: (P,) float32.

    The interpolation position is formed as the JAX package forms it: the
    Python position ``(n - 1) * q / 100`` enters as a float32, and ``lo``,
    ``hi`` and the fraction come from that float32 value."""
    cum = counts.cumsum(1)
    pos = np.float32((n - 1) * (q / 100.0))
    lo = int(np.floor(pos))
    hi = int(np.ceil(pos))
    frac = float(np.float32(pos - np.floor(pos)))
    # argmax returns the first maximal index: first v with count(x <= v) > lo.
    v_lo = torch.argmax((cum > lo).to(torch.int32), dim=1).to(torch.float32)
    v_hi = torch.argmax((cum > hi).to(torch.int32), dim=1).to(torch.float32)
    return v_lo + (v_hi - v_lo) * frac


def _percentile_u8(x: torch.Tensor, q: float) -> torch.Tensor:
    """Exact linear-interpolation percentile of uint8 images via a 256-bin
    histogram: (..., H, W) -> (...) float32, one value per image."""
    n = x.shape[-2] * x.shape[-1]
    return percentile_from_counts(u8_counts(x), n, q).reshape(x.shape[:-2])


def _per_image(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """Broadcast one scalar per image against (..., H, W)."""
    return v.reshape(v.shape + (1,) * ndim)


def adaptive_mask(white: torch.Tensor, black: torch.Tensor,
                  white_factor: float = 1.5, black_percentile: float = 95.0,
                  contrast_frac: float = 0.05) -> torch.Tensor:
    """Reference adaptive validity mask (`server/sl_system.py:526-535`) per
    (..., H, W) image: white > factor · P(black) AND
    (white − black) > frac · max contrast."""
    w = white.to(torch.float32)
    b = black.to(torch.float32)
    if black.dtype == torch.uint8:
        p = _percentile_u8(black, black_percentile)
    else:
        p = torch.quantile(b.reshape(b.shape[:-2] + (-1,)),
                           black_percentile / 100.0, dim=-1)
    contrast = w - b
    return masked_by_thresholds(w, contrast, white_factor * p,
                                contrast_frac * contrast.amax(dim=(-2, -1)))


def masked_by_thresholds(w: torch.Tensor, contrast: torch.Tensor,
                         thresh_w: torch.Tensor,
                         thresh_c: torch.Tensor) -> torch.Tensor:
    """The adaptive mask's last step: float32 white ``w`` and ``contrast``
    (..., H, W) against one white and one contrast threshold per image."""
    return (w > _per_image(thresh_w, 2)) & (contrast > _per_image(thresh_c, 2))


def fixed_mask(white: torch.Tensor, black: torch.Tensor,
               white_thresh: float = 40.0,
               contrast_thresh: float = 10.0) -> torch.Tensor:
    """Fixed-threshold mask (`multi_point_cloud_process.py:36-38`)."""
    w = white.to(torch.float32)
    b = black.to(torch.float32)
    return (w > white_thresh) & ((w - b) > contrast_thresh)


def decode_stack(stack: torch.Tensor, col_bits: int, row_bits: int,
                 cfg: DecodeConfig = DecodeConfig(), downsample: int = 1):
    """Full decode: a (F, H, W) stack — or a (B, F, H, W) batch — ->
    (col_map, row_map, mask), int32 projector pixel coordinates and the
    per-pixel validity, dense over all pixels."""
    single = stack.dim() == 3
    stacks = stack[None] if single else stack
    col_map, row_map = decode_maps(stacks.contiguous(), col_bits, row_bits,
                                   downsample)
    white, black = stacks[:, 0], stacks[:, 1]
    if cfg.mode == "adaptive":
        mask = adaptive_mask(white, black, cfg.white_factor,
                             cfg.black_percentile, cfg.contrast_frac)
    elif cfg.mode == "fixed":
        mask = fixed_mask(white, black, cfg.white_thresh, cfg.contrast_thresh)
    else:
        raise ValueError(f"unknown mask mode {cfg.mode!r}")
    if single:
        return col_map[0], row_map[0], mask[0]
    return col_map, row_map, mask
