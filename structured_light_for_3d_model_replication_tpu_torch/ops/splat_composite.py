"""The per-tile front-to-back splat composite (counterpart of the JAX
``ops/splat_render_pallas.py``): for every image tile, its K depth-sorted
splat records folded into T² pixels,

    power = (-0.5·(a·dx² + c·dy²)) − b·dx·dy
    alpha = clip(opa·exp(min(power, 0)), 0, 0.995)       (slot in the tile)
    rgb  += trans·alpha·colour;   trans *= 1 − alpha      (k = 0 … K−1)

returning (NT, T², 3) premultiplied colour and (NT, T²) alpha = 1 − trans.

On a CUDA tensor :func:`composite` launches the hand-written kernel
``csrc/composite.cu``; on a CPU tensor it takes the plain version
:func:`composite_reference`, the JAX package's ``_composite_xla`` (the
exclusive cumulative product along K), which the renderer's gradient path
also differentiates. The kernel has no backward, as in the JAX package:
:func:`composite` refuses inputs that require gradients.

A slot whose membership flag is 0 contributes nothing, whatever its record
holds: the plain version zeroes such records before the fold and the kernel
skips them, so a NaN in a masked slot poisons neither. With finite records
both give the JAX form's result (a masked slot's alpha is 0 there too).
"""

from __future__ import annotations

import torch

_PLANES = ("u", "v", "ca", "cb", "cc", "cr", "cg", "cbl", "opa", "ok")


def _pixel_grid(x0: torch.Tensor, y0: torch.Tensor, tile: int):
    """(NT, T²) pixel coordinates of every tile: row-major in the tile."""
    px = torch.arange(tile, dtype=torch.float32, device=x0.device).repeat(
        tile)
    py = torch.arange(tile, dtype=torch.float32,
                      device=x0.device).repeat_interleave(tile)
    return x0[:, None] + px[None, :], y0[:, None] + py[None, :]


def composite_reference(u, v, ca, cb, cc, cr, cg, cbl, opa, ok, x0, y0,
                        tile: int):
    """Plain PyTorch version (differentiable): (NT, K) record planes, ``ok``
    bool or 0/1 float, (NT,) tile origins → ((NT, T², 3) premultiplied
    colour, (NT, T²) alpha). Minimum and clip are ``torch.minimum`` /
    ``torch.maximum``, which split the gradient at a tie as ``jnp.minimum``
    and ``jnp.clip`` do."""
    okb = ok.to(torch.bool)
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    u, v, ca, cb, cc, cr, cg, cbl, opa = (
        torch.where(okb, a, zero) for a in (u, v, ca, cb, cc, cr, cg, cbl,
                                            opa))
    gx, gy = _pixel_grid(x0, y0, tile)
    dx = gx[:, :, None] - u[:, None, :]                      # (NT, T², K)
    dy = gy[:, :, None] - v[:, None, :]
    power = -0.5 * (ca[:, None, :] * dx * dx
                    + cc[:, None, :] * dy * dy) \
        - cb[:, None, :] * dx * dy
    g = torch.exp(torch.minimum(power, zero))
    alpha = torch.minimum(torch.maximum(opa[:, None, :] * g, zero),
                          torch.full((), 0.995, device=u.device)) \
        * okb[:, None, :].to(u.dtype)
    # Exclusive cumulative transmittance along the (sorted) K axis.
    trans = torch.cumprod(1.0 - alpha, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]],
                      dim=-1)
    w = trans * alpha
    rgb = torch.stack([torch.sum(w * c[:, None, :], dim=-1)
                       for c in (cr, cg, cbl)], dim=-1)
    a_out = 1.0 - torch.prod(1.0 - alpha, dim=-1)
    return rgb, a_out


def _check(planes, x0, y0, tile: int) -> None:
    u = planes[0]
    if u.dim() != 2:
        raise ValueError(f"composite: records must be (NT, K), got "
                         f"{tuple(u.shape)}")
    nt = u.shape[0]
    if not 1 <= tile or tile * tile > 1024:
        raise ValueError(f"composite: tile {tile} needs 1 ≤ tile² ≤ 1024")
    for name, t in zip(_PLANES, planes):
        if t.shape != u.shape:
            raise ValueError(f"composite: {name} is {tuple(t.shape)}, u "
                             f"{tuple(u.shape)}")
        if t.dtype != torch.float32 and not (name == "ok"
                                              and t.dtype == torch.bool):
            raise ValueError(f"composite: {name} must be float32, got "
                             f"{t.dtype}")
    for name, t in (("x0", x0), ("y0", y0)):
        if t.shape != (nt,) or t.dtype != torch.float32:
            raise ValueError(f"composite: {name} must be ({nt},) float32, "
                             f"got {tuple(t.shape)} {t.dtype}")
    for name, t in zip(_PLANES + ("x0", "y0"), (*planes, x0, y0)):
        if t.device != u.device:
            raise ValueError(f"composite: {name} is on {t.device}, u on "
                             f"{u.device}")
        if t.requires_grad:
            raise ValueError(
                f"composite: {name} requires grad, and the kernel has no "
                "backward; differentiate composite_reference instead "
                "(render(..., use_kernel=False))")


def composite(u, v, ca, cb, cc, cr, cg, cbl, opa, ok, x0, y0, tile: int):
    """(NT, K) float32 record planes (``ok`` bool or 0/1 float32), (NT,)
    float32 tile origins, the tile side ``tile`` (tile² ≤ 1024) →
    ((NT, tile², 3) premultiplied colour, (NT, tile²) alpha).

    A CUDA tensor launches ``sl_composite_cells`` (``csrc/composite.cu``),
    which reads ``ok`` at its own dtype, and raises if it cannot; only a
    CPU tensor takes :func:`composite_reference`. Inputs that require gradients raise on
    every device: the kernel has no backward."""
    planes = (u, v, ca, cb, cc, cr, cg, cbl, opa, ok)
    tile = int(tile)
    _check(planes, x0, y0, tile)
    if u.device.type == "cpu":
        return composite_reference(*planes, x0, y0, tile)
    if u.device.type != "cuda":
        raise ValueError(f"composite has no kernel for {u.device}")
    if not all(t.is_contiguous() for t in (*planes, x0, y0)):
        raise ValueError("composite needs contiguous operands")
    nt, k = u.shape
    rgb = torch.empty((nt, tile * tile, 3), dtype=torch.float32,
                      device=u.device)
    alpha = torch.empty((nt, tile * tile), dtype=torch.float32,
                        device=u.device)
    if nt == 0:
        return rgb, alpha
    from ..kernels import build

    lib = build.library()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sl_composite_cells(
            *(t.data_ptr() for t in planes), x0.data_ptr(), y0.data_ptr(),
            rgb.data_ptr(), alpha.data_ptr(), nt, k, tile,
            int(ok.dtype == torch.bool), stream)
    build.check(err, "sl_composite_cells")
    composite.launches += 1
    return rgb, alpha


composite.launches = 0
