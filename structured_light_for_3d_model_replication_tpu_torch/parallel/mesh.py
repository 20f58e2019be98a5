"""Device meshes for the scan workload (counterpart of the JAX package's
``parallel/mesh.py``).

Two axes, as in the JAX package:

* ``data`` — independent scans (turntable stops, batch jobs);
* ``space`` — blocks of camera rows within one scan. The decode is
  per-pixel, so a row block needs nothing from the others except the
  adaptive mask's per-image statistics (the black frame's 95th percentile
  and the maximum contrast), which :mod:`.pipeline` reduces by hand.

JAX places arrays with a ``NamedSharding`` and lets GSPMD insert the
collectives. PyTorch has no such propagation, so a :class:`Mesh` here is a
plain ``(data, space)`` grid of ``torch.device``s and the placements are
explicit functions: :func:`split_batch` cuts a ``(B, F, H, W)`` batch into
its members' blocks and :func:`gather_rows` brings the members' outputs
back in member order; ``parallel/pipeline.shard_inputs`` copies the
calibration to every member (JAX's ``replicated``). Devices are told apart
by label (``"cuda:1"``, ``"cpu:3"``): a host tensor sent to
``torch.device("cpu", 3)`` reports ``cpu``, so comparing ``tensor.device``
would not tell host members apart.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np
import torch

DATA_AXIS = "data"
SPACE_AXIS = "space"


def device_label(device) -> str:
    """``"type:index"`` of a device (index 0 when it has none) — the lane
    and span label of ``serve/lanes.py``."""
    device = torch.device(device)
    return f"{device.type}:{device.index or 0}"


def local_devices() -> list[torch.device]:
    """Every card this process sees, in enumeration order (empty without
    one: the host serves as a mesh only when the caller lists it)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(data, space)`` grid of devices. ``devices[d][s]`` is the member
    at data row ``d`` and space column ``s``."""

    devices: tuple[tuple[torch.device, ...], ...]
    axis_names: ClassVar[tuple[str, str]] = (DATA_AXIS, SPACE_AXIS)

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: len(self.devices),
                SPACE_AXIS: len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def flat(self) -> list[torch.device]:
        """Every member, data row by data row."""
        return [d for row in self.devices for d in row]

    @property
    def space_members(self) -> tuple[torch.device, ...]:
        """The first data row: the members an unbatched cloud is split
        over (JAX replicates it over ``data``; the port computes it
        once)."""
        return self.devices[0]

    def labels(self) -> list[str]:
        return [device_label(d) for d in self.flat]


def make_mesh(data: int | None = None, space: int = 1,
              devices=None) -> Mesh:
    """Build a (data, space) mesh over ``devices`` (None = every card).
    ``data=None`` takes all remaining devices. A device listed twice is
    refused, as JAX refuses it."""
    devices = [torch.device(d) for d in
               (devices if devices is not None else local_devices())]
    labels = [device_label(d) for d in devices]
    if len(set(labels)) != len(labels):
        dup = sorted({x for x in labels if labels.count(x) > 1})
        raise ValueError(f"mesh devices must be distinct; repeated: {dup}")
    if data is None:
        if len(devices) % space:
            raise ValueError(
                f"{len(devices)} devices not divisible by space={space}")
        data = len(devices) // space
    n = data * space
    if n > len(devices):
        raise ValueError(f"need {n} devices, have {len(devices)}")
    if n < 1:
        raise ValueError(f"a mesh needs at least one device (data={data}, "
                         f"space={space})")
    grid = tuple(tuple(devices[r * space:(r + 1) * space])
                 for r in range(data))
    return Mesh(grid)


def serve_space_mesh(n_devices: int, devices=None) -> Mesh:
    """The serving tier's sharded-bucket mesh: one job spans ``n_devices``
    cards with camera rows over the space axis (data = 1)."""
    return make_mesh(data=1, space=int(n_devices), devices=devices)


def resolve_device_labels(labels, devices=None) -> list[torch.device]:
    """The devices behind a span of ``"type:index"`` labels, in device
    ENUMERATION order (not label order): mesh row placement must not depend
    on how the span was sorted for its program key. Raises on a label no
    local device answers to."""
    devices = [torch.device(d) for d in
               (devices if devices is not None else local_devices())]
    want = set(labels)
    out = [d for d in devices if device_label(d) in want]
    if len(out) != len(want):
        have = {device_label(d) for d in devices}
        raise ValueError(
            f"unknown device label(s) {sorted(want - have)} in span "
            f"{sorted(want)}; local devices: {sorted(have)}")
    return out


def serve_span_mesh(labels, devices=None) -> Mesh:
    """Set-keyed serving mesh: one job spans EXACTLY the named devices, so
    the sharded tier can drop one dead member and keep the others."""
    devs = resolve_device_labels(labels, devices)
    return make_mesh(data=1, space=len(devs), devices=devs)


# -- explicit placements (JAX's NamedSharding helpers) -----------------------


def blocks(n: int, parts: int) -> list[tuple[int, int]]:
    """``(start, stop)`` of ``parts`` contiguous blocks of ``n`` rows, each
    ``ceil(n / parts)`` long and the last ones shorter or empty — the
    split GSPMD makes when it pads an uneven axis."""
    step = -(-n // parts)
    return [(min(n, i * step), min(n, (i + 1) * step)) for i in range(parts)]


def _to(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device).contiguous()


def split_batch(stacks, mesh: Mesh) -> list[list[torch.Tensor]]:
    """A ``(B, F, H, W)`` batch (host array or tensor) as its members'
    blocks: ``out[d][s]`` holds scans ``B``-block ``d`` and rows block
    ``s`` on ``mesh.devices[d][s]`` (JAX's ``stack_batch_sharding``)."""
    b, h = stacks.shape[0], stacks.shape[2]
    out = []
    for (b0, b1), row in zip(blocks(b, len(mesh.devices)), mesh.devices):
        out.append([_to(stacks[b0:b1, :, r0:r1], dev)
                    for (r0, r1), dev in zip(blocks(h, len(row)), row)])
    return out


def gather_rows(parts, dim: int, device) -> torch.Tensor:
    """Members' outputs concatenated along ``dim`` on ``device``, in
    member order."""
    return torch.cat([p.to(device) for p in parts], dim)
