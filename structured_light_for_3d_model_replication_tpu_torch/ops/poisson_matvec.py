"""The band-sparse screened-Poisson operator (counterpart of the JAX
``ops/poisson_pallas.py``): one CG matvec on (M, 512) flat 8³ bricks,

    out = block_valid · ((6 + W)·x − Σ six neighbours of x),

written as the JAX package's XLA form ``-(lap_band(x) − W·x)`` masked to
the band. In-brick neighbours are flat shifts (±64, ±8, ±1); cross-brick
faces come from the neighbour slots ``nbr`` (M, 6), columns
+x, −x, +y, −y, +z, −z, where a slot outside [0, M) means absent (zero).

On a CUDA tensor :func:`matvec_band` launches the hand-written kernel
``csrc/matvec.cu``; on a CPU tensor it takes the plain version
:func:`matvec_band_reference`. The two are bit-equal: the kernel sums the
six terms in the plain version's order and rounds every operation on its
own.
"""

from __future__ import annotations

import torch


def _check(x, W, nbr, block_valid) -> None:
    m = x.shape[0]
    if (x.dim() != 2 or x.shape[1] != 512 or W.shape != x.shape
            or nbr.shape != (m, 6) or block_valid.shape != (m,)):
        raise ValueError(
            f"matvec_band takes x, W (M, 512), nbr (M, 6) and block_valid "
            f"(M,); got {tuple(x.shape)}, {tuple(W.shape)}, "
            f"{tuple(nbr.shape)}, {tuple(block_valid.shape)}")
    for name, t, dt in (("x", x, torch.float32), ("W", W, torch.float32),
                        ("nbr", nbr, torch.int32),
                        ("block_valid", block_valid, torch.bool)):
        if t.dtype != dt:
            raise ValueError(f"matvec_band: {name} must be {dt}, got "
                             f"{t.dtype}")
        if t.device != x.device:
            raise ValueError(f"matvec_band: {name} is on {t.device}, x on "
                             f"{x.device}")


def matvec_band_reference(x: torch.Tensor, W: torch.Tensor,
                          nbr: torch.Tensor,
                          block_valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``where(band, -(lap_band(x) − W·x), 0)`` with
    the Laplacian of :func:`.poisson_sparse._lap_band_flat`."""
    from .poisson_sparse import _lap_band_flat

    m = x.shape[0]
    nb = torch.where((nbr >= 0) & (nbr < m), nbr, m).to(torch.int64)
    out = _lap_band_flat(x, nb) - W * x
    return torch.where(block_valid[:, None], -out,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def matvec_band(x: torch.Tensor, W: torch.Tensor, nbr: torch.Tensor,
                block_valid: torch.Tensor) -> torch.Tensor:
    """One screened-stencil matvec on the band: x, W (M, 512) float32,
    nbr (M, 6) int32, block_valid (M,) bool → (M, 512) float32, zero
    outside the band.

    A CUDA tensor launches ``sl_matvec_band`` (``csrc/matvec.cu``) and
    raises if it cannot; only a CPU tensor takes
    :func:`matvec_band_reference`."""
    _check(x, W, nbr, block_valid)
    if x.device.type == "cpu":
        return matvec_band_reference(x, W, nbr, block_valid)
    if x.device.type != "cuda":
        raise ValueError(f"matvec_band has no kernel for {x.device}")
    if not (x.is_contiguous() and W.is_contiguous() and nbr.is_contiguous()
            and block_valid.is_contiguous()):
        raise ValueError("matvec_band needs contiguous operands")
    from ..kernels import build

    lib = build.library()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sl_matvec_band(x.data_ptr(), W.data_ptr(), nbr.data_ptr(),
                                 block_valid.data_ptr(), out.data_ptr(),
                                 x.shape[0], stream)
    build.check(err, "sl_matvec_band")
    matvec_band.launches += 1
    return out


matvec_band.launches = 0
