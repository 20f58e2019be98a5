"""Device resolution and stage clocks shared by the public entry points."""

from __future__ import annotations

import time

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. A CUDA device without a card raises: the
    port never drops to the CPU on its own — the caller asks for it with
    ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the host")
    return dev


def div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` as a true IEEE division on every device. On CUDA a Python
    scalar divisor is turned into a multiply by its reciprocal, which
    rounds differently from the JAX package's division — and these
    quotients feed ``floor`` (voxel cells, histogram bins, strides)."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def stage_clock(dev: torch.device, timing: dict | None):
    """Wall-clock reader for stage edges: drains the device first when
    stage times are asked for (``timing`` given), and is free (returns 0.0)
    otherwise."""
    def clock() -> float:
        if timing is None:
            return 0.0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()
    return clock
