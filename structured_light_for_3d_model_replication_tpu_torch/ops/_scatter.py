"""Float scatter-sums that give the same bits on every run.

On the card, ``index_add_`` on a float tensor runs as atomics: the terms of
one destination row are added in the order the atomics land, so two runs on
the same inputs can differ in the last bits (seen on the H100 as a CG
iteration count, a splat count and a gate overlap that moved between runs).
Every float scatter-sum of the port goes through this module instead:

* :func:`scatter_sum` — arbitrary destinations, a sorting accumulate
  (``index_put_(accumulate=True)``, which sorts the indices and adds each
  row's terms in that order);
* :func:`segment_sum` — rows already sorted by destination (a contiguous
  ``group`` per destination), one segmented sum and no sort;
* :class:`ScatterPlan` — the same destinations summed many times (the
  restriction inside every CG iteration): the stable sort and the segment
  bounds are computed once, and each sum is a gather and a segmented sum.

On a CPU tensor each of them keeps ``index_add_``, which adds in index
order, so the CPU parity tests stay bit-equal to the JAX package. The form
is chosen by :func:`_card` from where the tensor lies.

Scatters of integers, or of ones below 2²⁴, are exact in any order and
stay as they are: ``ops/cluster.py`` (int64 counts), ``ops/brickknn_kernel.py``
(int64 counts and histogram), ``ops/decode.py`` (integer histogram),
``ops/features_brick.py`` and ``ops/tsdf.py``'s hit count (sums of ones),
and ``ops/posegraph.py``, which already uses the sorting
``index_put_(accumulate=True)``.
"""

from __future__ import annotations

import torch


def _card(t: torch.Tensor) -> bool:
    return t.is_cuda


def scatter_sum(size: int, idx: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
    """(size, …) zeros with the rows of ``vals`` (N, …) summed in at
    ``idx`` (N,) int64."""
    out = vals.new_zeros((size,) + tuple(vals.shape[1:]))
    if _card(vals):
        return out.index_put_((idx,), vals, accumulate=True)
    return out.index_add_(0, idx, vals)


def _segments(keys_sorted: torch.Tensor, size: int) -> torch.Tensor:
    """Segment bounds (size + 1,) of ascending destinations: segment j is
    rows ``offsets[j]:offsets[j + 1]``; empty where no row goes to j."""
    targets = torch.arange(size + 1, dtype=keys_sorted.dtype,
                           device=keys_sorted.device)
    return torch.searchsorted(keys_sorted, targets)


def _segment_reduce(vals: torch.Tensor, offsets: torch.Tensor):
    # unsafe=True skips the host-side check of the bounds (a sync).
    return torch.segment_reduce(vals, "sum", offsets=offsets, axis=0,
                                unsafe=True)


def segment_sum(vals: torch.Tensor, group: torch.Tensor,
                size: int) -> torch.Tensor:
    """(size, …) sums of the rows of ``vals`` (N, …) by ``group`` (N,)
    int64, which must be ascending (rows sorted by destination)."""
    if _card(vals):
        return _segment_reduce(vals, _segments(group, size))
    out = vals.new_zeros((size,) + tuple(vals.shape[1:]))
    return out.index_add_(0, group, vals)


class ScatterPlan:
    """Sums into ``size`` destinations at fixed ``idx`` (N,) int64, many
    times: on the card the stable sort of ``idx``, the destinations it
    reaches and their segment bounds are taken once, here (one host sync),
    and :meth:`sum` gathers, sums the segments and places each sum at its
    destination (distinct destinations: a plain, deterministic store).
    Only the destinations reached get a segment: PyTorch's segmented sum
    of 1-D values on the card takes a block a segment, and the
    restriction's 128³ coarse cells as segments cost more than a
    millisecond a CG iteration on the H100 (PERF.md)."""

    def __init__(self, idx: torch.Tensor, size: int):
        self.size = size
        self.card = _card(idx)
        self.idx = idx
        if self.card:
            self.perm = torch.argsort(idx, stable=True)
            self.dest, counts = torch.unique_consecutive(
                idx[self.perm], return_counts=True)
            self.offsets = torch.cat([counts.new_zeros(1),
                                      torch.cumsum(counts, 0)])

    def sum(self, vals: torch.Tensor) -> torch.Tensor:
        out = vals.new_zeros((self.size,) + tuple(vals.shape[1:]))
        if self.card:
            out[self.dest] = _segment_reduce(vals[self.perm], self.offsets)
            return out
        return out.index_add_(0, self.idx, vals)
