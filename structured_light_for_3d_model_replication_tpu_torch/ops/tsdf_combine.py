"""The TSDF running-average combine (counterpart of the JAX
``ops/tsdf_pallas.py``): one stop's scatter sums folded into the brick
pool,

    wsum = weight + den,  safe = max(wsum, 1e-12),  hit = den > 0
    tsdf' = hit ? (tsdf·weight + num) / safe : tsdf
    rgb'  = hit ? (rgb·weight + rgbnum) / safe : rgb      (per channel)
    weight' = min(wsum, max_weight)

— the XLA form of the JAX package's ``tsdf._combine`` (a true division;
the TPU kernel multiplied by a reciprocal). RGB and TSDF divide by the
pre-clamp weight sum; only the stored weight is clamped.

On a CUDA tensor :func:`tsdf_combine` launches the hand-written kernel
``csrc/combine.cu``; on a CPU tensor it takes the plain version
:func:`tsdf_combine_reference`. The two are bit-equal: the kernel rounds
every product, sum and quotient on its own.
"""

from __future__ import annotations

import torch


def _check(tsdf, weight, rgb, num, den, rgbnum, out) -> None:
    cap = tsdf.shape[0]
    plane = (cap, 512)
    if (tsdf.shape != plane or weight.shape != plane or num.shape != plane
            or den.shape != plane or rgb.shape != (cap, 512, 3)
            or rgbnum.shape != (cap, 512, 3)):
        raise ValueError(
            "tsdf_combine takes tsdf, weight, num, den (cap, 512) and rgb, "
            f"rgbnum (cap, 512, 3); got {tuple(tsdf.shape)}, "
            f"{tuple(weight.shape)}, {tuple(num.shape)}, {tuple(den.shape)}, "
            f"{tuple(rgb.shape)}, {tuple(rgbnum.shape)}")
    named = [("tsdf", tsdf), ("weight", weight), ("rgb", rgb), ("num", num),
             ("den", den), ("rgbnum", rgbnum)]
    if out is not None:
        named += [("out[0]", out[0]), ("out[1]", out[1]), ("out[2]", out[2])]
        if (out[0].shape != plane or out[1].shape != plane
                or out[2].shape != (cap, 512, 3)):
            raise ValueError("tsdf_combine: out must match tsdf, weight, rgb")
    for name, t in named:
        if t.dtype != torch.float32:
            raise ValueError(f"tsdf_combine: {name} must be float32, got "
                             f"{t.dtype}")
        if t.device != tsdf.device:
            raise ValueError(f"tsdf_combine: {name} is on {t.device}, tsdf "
                             f"on {tsdf.device}")


def tsdf_combine_reference(tsdf, weight, rgb, num, den, rgbnum,
                           max_weight: float):
    """Plain PyTorch version: returns new (tsdf', weight', rgb')."""
    wsum = weight + den
    safe = wsum.clamp_min(1e-12)
    hit = den > 0.0
    new_tsdf = torch.where(hit, (tsdf * weight + num) / safe, tsdf)
    new_rgb = torch.where(hit[..., None],
                          (rgb * weight[..., None] + rgbnum) / safe[..., None],
                          rgb)
    return new_tsdf, wsum.clamp_max(float(max_weight)), new_rgb


def tsdf_combine(tsdf: torch.Tensor, weight: torch.Tensor,
                 rgb: torch.Tensor, num: torch.Tensor, den: torch.Tensor,
                 rgbnum: torch.Tensor, max_weight: float, out=None):
    """Fold one stop's sums: tsdf, weight, num, den (cap, 512) float32, rgb,
    rgbnum (cap, 512, 3) float32 → (tsdf', weight', rgb'). ``out`` — a
    (tsdf', weight', rgb') triple of tensors to write, which may be the
    inputs themselves (the volume's in-place update) — is used on a CUDA
    tensor; a CPU tensor returns new tensors from the plain version.

    A CUDA tensor launches ``sl_tsdf_combine`` (``csrc/combine.cu``) and
    raises if it cannot; only a CPU tensor takes
    :func:`tsdf_combine_reference`."""
    _check(tsdf, weight, rgb, num, den, rgbnum, out)
    if tsdf.device.type == "cpu":
        return tsdf_combine_reference(tsdf, weight, rgb, num, den, rgbnum,
                                      max_weight)
    if tsdf.device.type != "cuda":
        raise ValueError(f"tsdf_combine has no kernel for {tsdf.device}")
    if out is None:
        out = (torch.empty_like(tsdf), torch.empty_like(weight),
               torch.empty_like(rgb))
    if not all(t.is_contiguous() for t in (tsdf, weight, rgb, num, den,
                                           rgbnum, *out)):
        raise ValueError("tsdf_combine needs contiguous operands")
    from ..kernels import build

    lib = build.library()
    with torch.cuda.device(tsdf.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sl_tsdf_combine(
            tsdf.data_ptr(), weight.data_ptr(), rgb.data_ptr(),
            num.data_ptr(), den.data_ptr(), rgbnum.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            tsdf.numel(), float(max_weight), stream)
    build.check(err, "sl_tsdf_combine")
    tsdf_combine.launches += 1
    return out


tsdf_combine.launches = 0
