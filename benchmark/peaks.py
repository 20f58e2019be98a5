"""The yardstick of the kernels: the card's published peaks and, for each
hand-written kernel of the port, the operations and bytes one launch needs,
worked out from its operands as the path called it (the formulas the port's
``chip_smoke.py`` settled on: each input byte read once, each output byte
written once; where the work depends on the data, what these inputs need).

A kernel's entry names the Python wrapper the benchmark records around
(module and attribute, every binding a caller looks it up through), the
fragment of its CUDA kernel's name in the profiler's trace, and ``need``:
called with the wrapper's arguments inside the traced slice, it returns a
function that gives (operations, bytes) once the slice has ended, so the
slice itself reads nothing back from the card."""

from __future__ import annotations

import torch

PORT = "structured_light_for_3d_model_replication_tpu_torch"

# NVIDIA H100 SXM data sheet, dense rates, at its 700 W limit.
PEAKS = {"bytes_per_s": 3.35e12, "fp32_flops": 67e12}

NN_FLOPS_PER_PAIR = 8          # 3 sub, 3 mul, 2 add


def _nearest_one(q, kt, p2v, *_a, **_k):
    e = q.shape[0] if q.dim() == 3 else 1
    m, n = q.shape[-2], kt.shape[-1]
    n_valid = torch.isfinite(p2v)

    def need():
        flops = NN_FLOPS_PER_PAIR * m * int(n_valid.sum())
        return flops, e * (4 * (3 * m + 4 * n) + 12 * m)
    return need


KERNELS = {
    "nearest_one": dict(patch=(("ops.nn", "nearest_one"),),
                        trace_name="nn1", need=_nearest_one),
}


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    at the fp32 peak and the bytes at the memory peak."""
    return max(flops / PEAKS["fp32_flops"], nbytes / PEAKS["bytes_per_s"])
