"""k = 1 nearest-neighbour sweep with a fused distance + running argmin
(counterpart of the JAX ``ops/nn_pallas.py``).

The correspondence sweep is ICP's floor: every ICP iteration, every
candidate count and every information matrix runs it. On a CUDA tensor
:func:`nearest_one` launches the hand-written kernel ``csrc/nn1.cu``; on a
CPU tensor it takes the plain version :func:`nearest_one_reference`. Both
take a leading edge axis (E independent sweeps, each against its own keys),
which the batched ring uses where the JAX package's fused ring ``vmap``s the
Pallas kernel: one launch for all E, each edge's result bit-equal to its
own single sweep.

Both compute exact direct-difference fp32 distances, dx² + dy² + dz² (not
the ‖q‖² + ‖p‖² − 2q·p expansion), with ties to the lowest key index. The
TPU kernel packs the key index into the low 13 mantissa bits of d², which
quantizes d² to ~2⁻¹⁰ relative and caps the key count at 8192; the port
drops that packing, so its d² is exact — it differs from the Pallas
kernel's by at most that quantization — and the key count is unbounded.
"""

from __future__ import annotations

import functools
import math

import torch

_KC = 1024   # key-table padding multiple (the JAX call shape)
_REF_CHUNK = 2048   # queries per step of the plain version


def key_table(points: torch.Tensor, valid: torch.Tensor | None = None):
    """Key-side operands from an (N, 3) cloud, or an (E, N, 3) batch:
    (keys_t (3, N'), p2v (1, N')), each with the leading E when batched,
    N' padded to a multiple of 1024 and padding/invalid keys carrying
    ‖p‖² = +inf. Build once when the same keys are swept repeatedly."""
    lead, n = points.shape[:-2], points.shape[-2]
    pts = points.to(torch.float32)
    if valid is None:
        valid = torch.ones(lead + (n,), dtype=torch.bool, device=pts.device)
    pad = (-n) % _KC
    if pad:
        pts = torch.cat([pts, pts.new_zeros(lead + (pad, 3))], dim=-2)
        valid = torch.cat([valid, valid.new_zeros(lead + (pad,))], dim=-1)
    p2 = torch.sum(pts * pts, dim=-1)
    p2v = torch.where(valid, p2, torch.full((), float("inf"),
                                            device=pts.device))[..., None, :]
    return pts.transpose(-1, -2).contiguous(), p2v.contiguous()


def nearest_one_reference(queries: torch.Tensor, keys_t: torch.Tensor,
                          p2v: torch.Tensor):
    """Plain PyTorch version of the kernel: chunked direct-difference d²
    with invalid keys at +inf and ``argmin`` (first occurrence). Returns
    (d² (M,) float32, idx (M,) int64); d² = +inf and idx = 0 where no key
    is valid. A batch of edges ((E, M, 3) queries) is this sweep looped
    over E, giving (E, M)."""
    if queries.dim() == 3:
        outs = [nearest_one_reference(q, k, p)
                for q, k, p in zip(queries, keys_t, p2v)]
        if not outs:
            return (queries.new_zeros((0, queries.shape[1])),
                    torch.zeros((0, queries.shape[1]), dtype=torch.int64,
                                device=queries.device))
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))
    valid = torch.isfinite(p2v[0])
    inf = torch.full((), float("inf"), device=queries.device)
    d2s, idxs = [], []
    for s in range(0, queries.shape[0], _REF_CHUNK):
        q = queries[s:s + _REF_CHUNK]
        dx = q[:, 0:1] - keys_t[0][None, :]
        dy = q[:, 1:2] - keys_t[1][None, :]
        dz = q[:, 2:3] - keys_t[2][None, :]
        d = dx * dx + dy * dy + dz * dz
        d = torch.where(valid[None, :], d, inf)
        j = torch.argmin(d, dim=1)
        d2s.append(torch.gather(d, 1, j[:, None])[:, 0])
        idxs.append(j)
    if not d2s:
        return (queries.new_zeros((0,)),
                torch.zeros((0,), dtype=torch.int64, device=queries.device))
    return torch.cat(d2s), torch.cat(idxs)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_shape(m: int, n: int, index: int,
                  edges: int = 1) -> tuple[int, int]:
    """(splits, queries per lane) of the CUDA launch. A block takes a tile
    of 32 · per_lane queries of one edge; ``splits`` blocks of one
    thread-block cluster share a tile, each sweeping 1/splits of the keys.
    Four queries a lane unless that leaves fewer than two blocks an SM,
    then two; the fewest splits (1, 2, 4 or 8) that put two blocks on every
    SM, while each block keeps at least 256 keys. The tiles of all
    ``edges`` count together."""
    target = 2 * _sm_count(index)
    for per_lane in (4, 2):
        tiles = edges * max(1, math.ceil(m / (32 * per_lane)))
        splits = 1
        while splits < 8 and tiles * splits < target and n >= 512 * splits:
            splits *= 2
        if tiles * splits >= target:
            break
    return splits, per_lane


_launch = None   # the bound ``sl_nearest_one`` of the loaded library


def nearest_one(queries: torch.Tensor, keys_t: torch.Tensor,
                p2v: torch.Tensor):
    """(M, 3) queries × transposed (3, N) keys → (d² (M,) float32,
    idx (M,) int64). ``p2v`` (1, N) is ‖p‖² with +inf at invalid keys (see
    :func:`key_table`). Rows with no valid key return d² = +inf; indices
    are always in range. With a leading edge axis — (E, M, 3), (E, 3, N),
    (E, 1, N) → (E, M) — each edge sweeps only its own keys.

    A CUDA tensor launches ``sl_nearest_one`` (``csrc/nn1.cu``, one kernel
    a call, whatever E) and raises if it cannot; only a CPU tensor takes
    :func:`nearest_one_reference`."""
    global _launch
    batched = queries.dim() == 3
    lead = tuple(queries.shape[:1]) if batched else ()
    if (queries.dim() not in (2, 3) or queries.shape[-1] != 3
            or keys_t.shape[:-1] != lead + (3,)
            or p2v.shape != lead + (1, keys_t.shape[-1])):
        raise ValueError(
            f"nearest_one takes (M, 3) queries, (3, N) keys and (1, N) p2v, "
            f"or the same with a leading edge axis E; got "
            f"{tuple(queries.shape)}, {tuple(keys_t.shape)}, "
            f"{tuple(p2v.shape)}")
    dev = queries.device
    for name, t in (("queries", queries), ("keys_t", keys_t), ("p2v", p2v)):
        if t.dtype != torch.float32:
            raise ValueError(f"nearest_one: {name} must be float32, got "
                             f"{t.dtype}")
        if t.device != dev:
            raise ValueError(f"nearest_one: {name} is on {t.device}, "
                             f"queries on {dev}")
    n = keys_t.shape[-1]
    if n == 0:
        raise ValueError("nearest_one needs at least one key slot")
    if dev.type == "cpu":
        return nearest_one_reference(queries, keys_t, p2v)
    if dev.type != "cuda":
        raise ValueError(f"nearest_one has no kernel for {dev}")
    if not (queries.is_contiguous() and keys_t.is_contiguous()
            and p2v.is_contiguous()):
        raise ValueError("nearest_one needs contiguous operands")
    from ..kernels import build

    if _launch is None:
        _launch = build.library().sl_nearest_one
    e = queries.shape[0] if batched else 1
    m = queries.shape[-2]
    d2 = torch.empty(lead + (m,), dtype=torch.float32, device=dev)
    idx = torch.empty(lead + (m,), dtype=torch.int64, device=dev)
    args = (queries.data_ptr(), keys_t.data_ptr(), p2v.data_ptr(),
            d2.data_ptr(), idx.data_ptr(), e, m, n,
            *_launch_shape(m, n, dev.index, e),
            torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():
        err = _launch(*args)
    else:
        with torch.cuda.device(dev):
            err = _launch(*args)
    build.check(err, "sl_nearest_one")
    nearest_one.launches += 1
    return d2, idx


nearest_one.launches = 0
