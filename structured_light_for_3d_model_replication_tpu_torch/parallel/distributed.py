"""Multi-process initialization — the ``torch.distributed`` entry
(counterpart of the JAX package's ``parallel/distributed.py``).

Kept as thin as the JAX package keeps it: one environment-driven,
idempotent, guarded initializer and a helper for the world size.

Environment contract, as in the JAX package:

* ``SL_COORDINATOR`` — ``host:port`` of process 0;
* ``SL_NUM_PROCESSES`` / ``SL_PROCESS_ID`` — world size and this rank.

Where the JAX package also reads JAX's own names
(``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``),
the port reads the names a PyTorch launcher (``torchrun``) sets:
``MASTER_ADDR`` with ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.

With none of these set, :func:`initialize_from_env` is a no-op returning
False. A coordinator without the world size or the rank is a
misconfiguration and raises. The backend is ``nccl`` for the card (the
default) and ``gloo`` when the caller asks for the host
(``device="cpu"``); where the JAX package reads ``JAX_PLATFORMS``, the port
takes the device from its caller, as every entry point of the port does.
"""

from __future__ import annotations

import os

import torch

from .._device import resolve_device
from ..utils.log import get_logger

log = get_logger(__name__)

_initialized = False


def _env(*names: str) -> str | None:
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return None


def _coordinator() -> str | None:
    coord = _env("SL_COORDINATOR")
    if coord is not None:
        return coord
    addr, port = _env("MASTER_ADDR"), _env("MASTER_PORT")
    if addr is None:
        return None
    return f"{addr}:{port}" if port is not None else addr


def initialize_from_env(device=None) -> bool:
    """Initialize ``torch.distributed`` from the environment (idempotent).

    Returns True when a multi-process group was (or already is)
    initialized, False when the environment asks for none. ``device`` picks
    the backend: None (the card) is ``nccl``, ``"cpu"`` is ``gloo``; a rank
    on the card takes card ``rank % device_count`` as its current
    device."""
    global _initialized
    if _initialized:
        return True
    coord = _coordinator()
    if coord is None:
        return False
    nproc = _env("SL_NUM_PROCESSES", "WORLD_SIZE")
    pid = _env("SL_PROCESS_ID", "RANK")
    if nproc is None or pid is None:
        raise RuntimeError(
            "SL_COORDINATOR is set but SL_NUM_PROCESSES/SL_PROCESS_ID are "
            "not — a partial multi-process environment is a "
            "misconfiguration, refusing to guess")
    import torch.distributed as dist

    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    rank, world_size = int(pid), int(nproc)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count()
                              if dev.index is None else dev.index)
    if not dist.is_initialized():
        dist.init_process_group(backend=backend,
                                init_method=f"tcp://{coord}",
                                world_size=world_size, rank=rank)
    _initialized = True
    log.info("torch.distributed initialized: rank %s/%s via %s (%s)", pid,
             nproc, coord, backend)
    return True


def world() -> tuple[int, int]:
    """(rank, world size) — (0, 1) when uninitialized."""
    if not _initialized:
        return 0, 1
    import torch.distributed as dist

    return dist.get_rank(), dist.get_world_size()
