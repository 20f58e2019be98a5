#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port on one NVIDIA GPU:
``structured_light_for_3d_model_replication_tpu_torch``, from stacks to the
merged 360° cloud and on to the printable STL, through the streaming
session and its splat appearance tier (rendered novel views), and through
the cleanup path of a single capture, with its CUDA kernels.

    python3 chip_smoke.py                  # the full run (no arguments)
    python3 chip_smoke.py --kernels-only   # build + kernel checks, no result
    python3 chip_smoke.py --profile        # full run + a profiled main path
    python3 chip_smoke.py --diagnose-determinism  # deterministic mode

Phases, in order; any failure exits non-zero before the result line:

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions, and
   the TF32 flags (both set False and printed);
2. build of the CUDA kernels from ``csrc/`` (one ``nvcc -c`` per source, all
   started together, then one link), with its time;
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes and at ragged ones (``nearest_one`` and ``matvec_band``
   bit for bit), then timed beside its bound, its plain version and, where
   one exists, a library yardstick: with CUDA events, and by the profiler
   where the kernel is shorter than its wrapper's host work (the composite,
   ``nearest_one`` and ``matvec_band`` print both);
4. the main path at full size — 24 stops × 15°, 1080×1920 camera, 1920×1080
   projector, 46 frames (the repository's headline 360° configuration) —
   through ``scan_stacks_to_cloud``, then ``mesh_360`` of the merged cloud
   at depth 10 into a temporary STL (bench.py config 6 settings); each half
   with its kernels' launch counters zeroed before and read after; stage
   times, peak memory, the merged cloud and every pose against the
   commanded turntable angle, the band, the CG iterations, the mesh against
   the scene's analytic surface and the STL read back. Each half then runs
   again on the same inputs (the mesh from the first run's merged cloud)
   and must repeat bit for bit: poses, merged points, colours and normals,
   the CG iteration count, the launch counts, mesh vertices and faces; a
   run whose results differ fails. ``nearest_one`` is then checked and
   timed on the 360° path's own sweeps, by shape, and ``matvec_band`` on
   the mesh path's own band (``scripts/torch_compare_trees.py`` times two
   trees of the port against each other with the same helpers);
5. the streaming path on the same 24-stop ring through
   ``IncrementalSession.add_stop`` ×24 → ``finalize(overlap=True)``:
   session T in the default ``"tsdf"`` lane (TSDF previews after every stop,
   a coloured TSDF final mesh read back from PLY) and session P in the
   ``"poisson"`` lane (coarse Poisson previews warm-starting the depth-10
   final), each with its kernels' launch counters zeroed before and read
   after. Session T runs bench config 11's settings (sequential finalize,
   covisibility gate on) and must skip the stops the JAX package's session
   skips on this ring; session P runs the pose graph (loop edge, LM)
   with the gate off. Then ``mesh_from_cloud(representation="tsdf")`` of
   session T's cloud twice in sequence and once through
   ``mesh_from_cloud_async``, compared bit for bit. The 360°, mesh and
   streaming paths must not launch the brick KNN kernel: their clouds stay
   below its 131,072 points;
5b. the splat appearance tier on the same ring, bench config 12: stops
   0–22 through a ``"splat"`` session, ``ensure_scene`` (seed on the fused
   TSDF shell + 200 Adam steps against 8 buffered frames, no composite
   launch), a 20-view orbit sweep at 384×288 through the composite kernel,
   and the render from held-out stop 23's predicted camera against the
   captured RGB, which must be no worse than the JAX package's on this ring
   (bench [12]'s 20 dB gate is printed; neither package meets it here),
   while the fit's 8 training views must average 20 dB; the PNG and the
   scene's npz read back to the same pixels;
6. the cleanup path of the reference's Process tab on one 1080×1920 stop
   of the bump scene with the rig's wall at z = 700: reconstruct → PLY
   written and read back → ``remove_background`` → ``remove_outliers`` →
   ``reconstruct_stl`` at depth 10, with the brick KNN kernel launched by
   the outlier removal and by the normals of the cleaned cloud;
7. the whole path on the tests' small 4-stop rig, scan and depth-9 mesh, a
   4-stop TSDF session, a 4-stop splat session, the ring with the brick
   FPFH and the cleanup path of one walled stop, on the card and on the
   host (the plain versions), compared by outcome;
8. a ``kernels`` JSON line, the card line again, and last the result line
   ``{"ok": true, "device": {...}}``.

Needs a CUDA card; without one it exits non-zero and prints no result. The
port (and nothing of the JAX package) must be importable from the working
directory.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12        # non-tensor fp32, H100 SXM data sheet
NN_FLOPS_PER_PAIR = 8          # 3 sub, 3 mul, 2 add
# Unfused, as bit-equality needs: 3 sub, 3 mul, 2 add, a compare, 2 selects.
NN_INSTR_PER_PAIR = 11
H100_FP32_LANE_OPS = H100_FP32_FLOPS / 2   # instructions/s: an FMA is 2 FLOP
# The splat composite per live (pixel, record) pair: 11 for the conic, 4 and
# an expf for alpha, 10 for the fold (csrc/composite.cu).
COMPOSITE_FLOPS_PER_PAIR = 25
N_STOPS, STEP_DEG = 24, 15.0   # the headline ring (bench.py:337-380)
BRICK_N = 1 << 20              # bench config 3b's cloud (bench.py:1135-1181)
# What the JAX package's session decides on this ring with the covisibility
# gate on (scripts/torch_gate_witness.py): the model test skips the last two
# stops, whose views the fused ring already covers.
REFERENCE_SKIPS = ((22, "skipped_covisible"), (23, "skipped_covisible"))


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_calls(fn, reps: int, kernels=None) -> tuple[float, dict]:
    """Device milliseconds per call of ``fn``, by ``torch.profiler``: for
    a kernel shorter than its wrapper's host work, where CUDA events around
    a loop of calls time the host. ``kernels`` are name fragments of the
    kernels one call launches (``None``: every kernel recorded); the
    result is the sum of their mean spans, each times its launches a call.
    ``fn`` runs twice ``reps`` times under the profiler, which can miss
    launches (it once recorded 185 of 200 on the splat path's records);
    every launch of one kernel does the same work, so the mean over those
    recorded stands for all. Also returns every CUDA kernel the profiler
    recorded over those calls, by name, with its count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2 * reps):
            fn()
        torch.cuda.synchronize()
    spans = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.setdefault(e.name, []).append(
                e.time_range.end - e.time_range.start)
    total_us = 0.0
    for kernel in spans if kernels is None else kernels:
        got = [t for name, ts in spans.items() if kernel in name for t in ts]
        print(f"  profiler: {len(got)} of {2 * reps} calls' launches of "
              f"{kernel[:60]} recorded", flush=True)
        if len(got) < reps:
            fail(f"the profiler recorded {len(got)} launches of {kernel}, "
                 f"fewer than {reps}")
        total_us += sum(got) / len(got) * max(1, round(len(got) / (2 * reps)))
    return total_us / 1e3, {name: len(ts) for name, ts in spans.items()}


@contextlib.contextmanager
def sweep_tally():
    """While open, registration's correspondence sweep (``_nn1``, the only
    caller of ``nearest_one``) is tallied by shape: the yielded dict maps
    (queries, keys) to (sweeps, the first sweep's operands (q, keys_t,
    p2v))."""
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        nn,
        registration,
    )

    sweeps = {}
    real = registration._nn1

    def tallied(moved, dst_pts, dst_valid, src_valid, table=None):
        if table is None:
            table = nn.key_table(dst_pts, dst_valid)
        key = (moved.shape[0], table[0].shape[1])
        count, first = sweeps.get(key, (0, (moved.contiguous(), *table)))
        sweeps[key] = (count + 1, first)
        return real(moved, dst_pts, dst_valid, src_valid, table)

    registration._nn1 = tallied
    try:
        yield sweeps
    finally:
        registration._nn1 = real


@contextlib.contextmanager
def cg_matvecs(dev):
    """While open, ``poisson_sparse.matvec_band`` (the fine CG's operator:
    once before its loop and once an iteration) is wrapped: the yielded
    dict keeps the first call's operands under ``"band"`` (x, W, nbr,
    block_valid) and, on the card, a CUDA event at every call under
    ``"events"``, which :func:`cg_iteration_ms` reads after the run."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        poisson_sparse,
    )

    seen = {"band": None, "events": []}
    real = poisson_sparse.matvec_band

    def captured(x, W, nbr, bv):
        if seen["band"] is None:
            seen["band"] = (x, W, nbr, bv)
        if dev.type == "cuda":
            seen["events"].append(torch.cuda.Event(enable_timing=True))
            seen["events"][-1].record()
        return real(x, W, nbr, bv)

    poisson_sparse.matvec_band = captured
    try:
        yield seen
    finally:
        poisson_sparse.matvec_band = real


def cg_iteration_ms(events) -> float:
    """Device milliseconds per CG iteration, from the first matvec's event
    to the last (:func:`cg_matvecs`; the stream synchronized)."""
    if len(events) < 2:
        return float("nan")
    return events[0].elapsed_time(events[-1]) / (len(events) - 1)


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_decode(dev):
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.ops import decode

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    max_err = 0
    main = None
    for shape, bits, ds in (((6, 46, 1080, 1920), (11, 11), 1),
                            ((1, 32, 97, 161), (8, 7), 2),
                            ((3, 32, 97, 161), (8, 7), 1)):
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                          generator=g)
        col, row = decode.decode_maps(x, *bits, downsample=ds)
        rcol, rrow = decode.decode_maps_reference(x, *bits, downsample=ds)
        torch.cuda.synchronize()
        err = max(int((col - rcol).abs().max()), int((row - rrow).abs().max()))
        print(f"decode_maps {tuple(shape)} ds={ds}: max |kernel - plain| = "
              f"{err}", flush=True)
        if err != 0:
            fail(f"decode_maps disagrees with its plain version at {shape}")
        max_err = max(max_err, err)
        if main is None:
            main = (x, bits, ds)
    x, bits, ds = main
    b, f, h, w = x.shape
    ms = cuda_ms(lambda: decode.decode_maps(x, *bits, downsample=ds), 50)
    plain_ms = cuda_ms(
        lambda: decode.decode_maps_reference(x, *bits, downsample=ds), 5)
    # Planes 0 and 1 (white, black) feed only the mask, computed outside
    # the kernel: the function reads the f - 2 bit planes.
    nbytes = b * (f - 2) * h * w + 8 * b * h * w
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    print(f"decode_maps {tuple(x.shape)}: {ms:.4f} ms/launch, bound "
          f"{bound_ms:.4f} ms (bytes, {nbytes / 1e6:.1f} MB), plain "
          f"{plain_ms:.3f} ms, library yardstick: none", flush=True)
    return dict(name="decode_maps", route="cuda",
                source="structured_light_for_3d_model_replication_tpu_torch/"
                       "csrc/decode.cu",
                replaces="structured_light_for_3d_model_replication_tpu/ops/"
                         "decode_pallas.py:57",
                max_abs_err=float(max_err), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=None)


def nn_operands(dev, g, m: int, n: int, invalid: float,
                twice: bool = False):
    """m queries and n keys around z = 500 mm (a fraction ``invalid`` of
    the keys masked off; ``twice``: the second half of the keys repeats
    the first, so every query ties): (q, keys_t, p2v, points, valid)."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.ops import nn

    q = torch.randn((m, 3), device=dev, generator=g) * 50 + 500
    p = torch.randn((n - n // 2 if twice else n, 3), device=dev,
                    generator=g) * 50 + 500
    if twice:
        p = torch.cat([p, p[:n // 2]])
    valid = torch.rand((n,), device=dev, generator=g) >= invalid
    kt, p2v = nn.key_table(p, valid)
    return q, kt, p2v, p, valid


def nn_timing(q, kt, p2v, label: str) -> dict:
    """``nearest_one`` at one shape: its kernels' device time per call (the
    profiler), the call's time with the wrapper (CUDA events), the kernels
    one call launches (the profiler's record), its bound (8 operations per
    pair with a valid key at the fp32 peak) and its issue-rate floor (11
    fp32 instructions per pair, valid or not, at 128 lanes per SM)."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.ops import nn

    calls = 200
    ms, seen = profile_calls(lambda: nn.nearest_one(q, kt, p2v), calls,
                             ("nn1",))
    per_call = sum(seen.values()) / (2 * calls)
    call_ms = cuda_ms(lambda: nn.nearest_one(q, kt, p2v), calls)
    m, n = q.shape[0], kt.shape[1]
    n_valid = int(torch.isfinite(p2v).sum())
    flops = NN_FLOPS_PER_PAIR * m * n_valid
    nbytes = 4 * (3 * m + 4 * n) + 12 * m
    bound_ms = max(flops / H100_FP32_FLOPS, nbytes / H100_BYTES_PER_S) * 1e3
    floor_ms = NN_INSTR_PER_PAIR * m * n / H100_FP32_LANE_OPS * 1e3
    print(f"nearest_one {label} {m}x{n} ({n_valid} valid keys): {ms:.4f} ms "
          f"a call on the device, {call_ms:.4f} ms a call with the wrapper; "
          f"kernels recorded over {2 * calls} calls {seen} ({per_call:.3f} "
          f"a call); bound {bound_ms:.4f} ms (operations, "
          f"{flops / 1e9:.3f} GFLOP), issue-rate floor {floor_ms:.4f} ms "
          f"({NN_INSTR_PER_PAIR} fp32 instructions a pair)", flush=True)
    if len(seen) != 1 or per_call > 1.0:
        fail(f"nearest_one launched {seen} over {2 * calls} calls, not one "
             "kernel a call")
    return dict(ms=ms, call_ms=call_ms, bound_ms=bound_ms,
                floor_ms=floor_ms)


def check_nearest_one(dev):
    """``nearest_one`` bit-equal to its plain version (d2's bits and idx,
    ties to the lowest index, +inf and idx 0 without a valid key) at the
    360° path's two shapes (2048 warm-up and 8192 queries against 8192
    keys), a ragged shape, tables of 40,000 and 20,000 keys (several
    shared-memory chunks a block, at two and four queries a lane), a table
    whose every key appears twice, and a table with no valid key; then
    timed at both path shapes."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.ops import nn

    g = torch.Generator(device=dev)
    g.manual_seed(1)
    cases = (("8192x8192, 20% invalid", 8192, 8192, 0.2, False),
             ("2048x8192, 20% invalid", 2048, 8192, 0.2, False),
             ("1500x1100, 20% invalid", 1500, 1100, 0.2, False),
             ("1500x40000, 20% invalid", 1500, 40_000, 0.2, False),
             ("16384x20000, 20% invalid", 16_384, 20_000, 0.2, False),
             ("700x10000, every key twice", 700, 10_000, 0.0, True),
             ("64x128, all invalid", 64, 128, 1.0, False))
    shapes = {}
    for label, m, n, invalid, twice in cases:
        q, kt, p2v, p, valid = nn_operands(dev, g, m, n, invalid, twice)
        d2, idx = nn.nearest_one(q, kt, p2v)
        rd2, ridx = nn.nearest_one_reference(q, kt, p2v)
        torch.cuda.synchronize()
        same = (torch.equal(d2.view(torch.int32), rd2.view(torch.int32))
                and torch.equal(idx, ridx))
        finite = torch.isfinite(rd2)
        first = bool((idx < n // 2).all())
        print(f"nearest_one {label}: d2 bits and idx equal to the plain "
              f"version: {same} ({int(finite.sum())} rows with a valid key"
              f"{f'; every idx in the first copy: {first}' if twice else ''})",
              flush=True)
        if not same:
            fail(f"nearest_one disagrees with its plain version ({label})")
        if not bool(valid[idx[finite]].all()):
            fail(f"nearest_one {label}: idx points at an invalid key")
        if twice and not first:
            fail(f"nearest_one {label}: a tie went past the lowest index")
        if not bool(finite.any()) and not bool((idx == 0).all()):
            fail(f"nearest_one {label}: idx not 0 without valid keys")
        if n == 8192:
            shapes[(m, n)] = (q, kt, p2v, p, valid)
    q, kt, p2v, p, valid = shapes[(8192, 8192)]
    main = nn_timing(q, kt, p2v, "(random keys)")
    nn_timing(*shapes[(2048, 8192)][:3], "(random keys)")
    plain_ms = cuda_ms(lambda: nn.nearest_one_reference(q, kt, p2v), 20)
    pv = p[valid]
    lib_ms = cuda_ms(lambda: torch.cdist(q, pv).argmin(1), 20)
    print(f"nearest_one 8192x8192: plain {plain_ms:.3f} ms, library "
          f"torch.cdist(q, k).argmin(1) {lib_ms:.3f} ms", flush=True)
    return dict(name="nearest_one", route="cuda",
                source="structured_light_for_3d_model_replication_tpu_torch/"
                       "csrc/nn1.cu",
                replaces="structured_light_for_3d_model_replication_tpu/ops/"
                         "nn_pallas.py:99",
                max_abs_err=0.0, ms=main["ms"], plain_ms=plain_ms,
                bound_ms=main["bound_ms"], bound_by="operations",
                library_ms=lib_ms)


def sphere_band(dev):
    """The band of a sphere of radius 80 mm sampled by 100 000 points with
    their normals, built by the port's ``_setup_sparse`` at depth 10 with
    131 072 block slots: (rhs, W, nbr, block_valid)."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        poisson_sparse,
    )

    g = torch.Generator(device=dev)
    g.manual_seed(2)
    u = torch.randn((100_000, 3), device=dev, generator=g)
    u = u / u.norm(dim=1, keepdim=True)
    pts = u * 80.0 + torch.tensor([0.0, 10.0, 500.0], device=dev)
    out = poisson_sparse._setup_sparse(
        pts, u, torch.ones(pts.shape[0], dtype=torch.bool, device=dev),
        2 ** 10, 131_072, torch.tensor(4.0, device=dev))
    print(f"sphere band at depth 10: {int(out[11])} blocks, "
          f"{int(out[3].sum())} of them in the 131072 slots", flush=True)
    return out[0], out[1], out[2], out[3]


def matvec_timing(x, W, nbr, bv, label: str) -> dict:
    """``matvec_band`` on one band: its kernel's device time (the
    profiler), the call's time with the wrapper (CUDA events), its plain
    version's and its byte bound."""
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        poisson_matvec as pm,
    )

    ms, _ = profile_calls(lambda: pm.matvec_band(x, W, nbr, bv), 50,
                          ("matvec_band",))
    call_ms = cuda_ms(lambda: pm.matvec_band(x, W, nbr, bv), 100)
    plain_ms = cuda_ms(lambda: pm.matvec_band_reference(x, W, nbr, bv), 5)
    m = x.shape[0]
    n_valid = int(bv.sum())
    # Valid brick: x, W read and out written; invalid brick: out written;
    # every brick: nbr and block_valid read. Face halos hit L2.
    nbytes = 3 * 2048 * n_valid + 2048 * (m - n_valid) + 25 * m
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    print(f"matvec_band {label} M={m} ({n_valid} valid): {ms:.4f} ms on the "
          f"device, {call_ms:.4f} ms a call with the wrapper, bound "
          f"{bound_ms:.4f} ms (bytes, {nbytes / 1e6:.1f} MB; "
          f"{bound_ms / ms:.2f} of it), plain {plain_ms:.3f} ms, library "
          f"yardstick: none", flush=True)
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms)


def check_matvec(dev, band):
    """``matvec_band`` bit-equal to its plain version on the sphere band
    (x = rhs and a random x) and on a ragged prefix with a tenth of its
    bricks invalid; then timed on the band."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        poisson_matvec as pm,
    )

    rhs, W, nbr, bv = band
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    xr = torch.randn(rhs.shape, device=dev, generator=g)
    # A ragged prefix (neighbours past it count as absent) with a tenth of
    # its bricks marked invalid.
    mr = 100_003
    bvr = bv[:mr] & (torch.rand((mr,), device=dev, generator=g) > 0.1)
    cases = (("band, x = rhs", rhs, W, nbr, bv),
             ("band, random x", xr, W, nbr, bv),
             (f"first {mr} rows, 10% invalid, random x", xr[:mr], W[:mr],
              nbr[:mr], bvr))
    for label, x, w, nb, v in cases:
        got = pm.matvec_band(x, w, nb, v)
        ref = pm.matvec_band_reference(x, w, nb, v)
        torch.cuda.synchronize()
        same = torch.equal(got, ref)
        print(f"matvec_band {label}: equal to the plain version: {same} "
              f"(max |kernel - plain| = {float((got - ref).abs().max()):.3e})",
              flush=True)
        if not same:
            fail(f"matvec_band disagrees with its plain version ({label})")
    t = matvec_timing(rhs, W, nbr, bv, "sphere band")
    return dict(name="matvec_band", route="cuda",
                source="structured_light_for_3d_model_replication_tpu_torch/"
                       "csrc/matvec.cu",
                replaces="structured_light_for_3d_model_replication_tpu/ops/"
                         "poisson_pallas.py:130",
                max_abs_err=0.0, ms=t["ms"], plain_ms=t["plain_ms"],
                bound_ms=t["bound_ms"], bound_by="bytes", library_ms=None)


def check_classify(dev, band):
    import torch
    import torch.nn.functional as F

    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        marching_classify as mc,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        marching_device,
    )

    rhs, _, nbr, bv = band
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    c9 = marching_device.corner_frame(rhs, nbr)
    iso0 = torch.zeros((), device=dev)
    cases = [("band corner frame, iso 0", c9, iso0, bv)]
    # Random frames whose values sit at iso and within one ulp of it, with
    # an iso of scan scale and with iso 0 among subnormals.
    for label, iso in (("iso 0.0137 +- 1 ulp", 0.0137), ("iso 0 +- subnormal",
                                                         0.0)):
        iso_t = torch.tensor(iso, device=dev)
        k = torch.randint(-1, 2, (4096, 729), device=dev, generator=g)
        vals = torch.where(k < 0, torch.nextafter(iso_t, iso_t - 1),
                           torch.where(k > 0, torch.nextafter(iso_t, iso_t + 1),
                                       iso_t.expand(4096, 729)))
        valid = torch.rand((4096,), device=dev, generator=g) > 0.1
        cases.append((label, vals.contiguous(), iso_t, valid))
    for label, c, iso, v in cases:
        got = mc.classify_cells(c, iso, v)
        ref = mc.classify_cells_reference(c, iso, v)
        torch.cuda.synchronize()
        diff = int((got != ref).sum())
        print(f"classify_cells {label}: {int(ref.sum())} active cells, "
              f"max |kernel - plain| = {int(diff > 0)} ({diff} cells differ)",
              flush=True)
        if diff:
            fail(f"classify_cells disagrees with its plain version ({label})")
    m = c9.shape[0]
    ms = cuda_ms(lambda: mc.classify_cells(c9, iso0, bv), 100)
    plain_ms = cuda_ms(lambda: mc.classify_cells_reference(c9, iso0, bv), 5)

    def pooled():
        inside = (c9 > iso0).to(torch.float32).view(m, 1, 9, 9, 9)
        any_in = F.max_pool3d(inside, kernel_size=2, stride=1)
        all_in = -F.max_pool3d(-inside, kernel_size=2, stride=1)
        return ((any_in > 0.5) & (all_in < 0.5)).view(m, 512) & bv[:, None]

    if not torch.equal(pooled(), mc.classify_cells(c9, iso0, bv)):
        fail("the max_pool3d yardstick computes another function")
    lib_ms = cuda_ms(pooled, 20)
    nbytes = m * (729 * 4 + 512 + 1)
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    print(f"classify_cells M={m}: {ms:.4f} ms/launch, bound {bound_ms:.4f} "
          f"ms (bytes, {nbytes / 1e6:.1f} MB), plain {plain_ms:.3f} ms, "
          f"library max_pool3d any/all {lib_ms:.3f} ms", flush=True)
    return dict(name="classify_cells", route="cuda",
                source="structured_light_for_3d_model_replication_tpu_torch/"
                       "csrc/classify.cu",
                replaces="structured_light_for_3d_model_replication_tpu/ops/"
                         "marching_pallas.py:54",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=lib_ms)


def check_combine(dev):
    """``tsdf_combine`` against its plain version at session T's 16,384
    brick slots (random state) and at a ragged 1,000 slots with ``den = 0``
    over half the voxels and weights at and above the clamp; out of place
    and in place (the volume's own update). Exact: the kernel rounds op by
    op like the plain version."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        tsdf_combine as tc,
    )

    g = torch.Generator(device=dev)
    g.manual_seed(5)
    wmax = 64.0

    def state(cap, half_empty):
        def u(*shape, lo=0.0, hi=1.0):
            return torch.rand(shape, device=dev, generator=g) * (hi - lo) + lo
        tsdf, weight = u(cap, 512, lo=-1.0), u(cap, 512, hi=2.0 * wmax)
        rgb = u(cap, 512, 3, hi=255.0)
        den = u(cap, 512, hi=4.0)
        if half_empty:
            den = torch.where(torch.rand((cap, 512), device=dev,
                                         generator=g) < 0.5,
                              torch.zeros((), device=dev), den)
            weight[:, ::7] = wmax        # exactly at the clamp
        num = den * u(cap, 512, lo=-1.0)
        rgbnum = den[..., None] * u(cap, 512, 3, hi=255.0)
        return tsdf, weight, rgb, num, den, rgbnum

    max_err = 0.0
    main = None
    for label, cap, half in (("16384 slots, random state", 16_384, False),
                             ("1000 slots, den = 0 on half, weights at and "
                              "above the clamp", 1_000, True)):
        args = state(cap, half)
        ref = tc.tsdf_combine_reference(*args, wmax)
        got = tc.tsdf_combine(*args, wmax)
        inplace = tuple(a.clone() for a in args[:3])
        tc.tsdf_combine(*inplace, *args[3:], wmax, out=inplace)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        err_in = max(float((a - b).abs().max()) for a, b in zip(inplace, ref))
        print(f"tsdf_combine {label}: max |kernel - plain| = {err:.3e}, in "
              f"place {err_in:.3e}", flush=True)
        if err != 0.0 or err_in != 0.0:
            fail(f"tsdf_combine disagrees with its plain version ({label})")
        max_err = max(max_err, err, err_in)
        if main is None:
            main = args
    cap = main[0].shape[0]
    out = tuple(torch.empty_like(a) for a in main[:3])
    ms = cuda_ms(lambda: tc.tsdf_combine(*main, wmax, out=out), 100)
    plain_ms = cuda_ms(lambda: tc.tsdf_combine_reference(*main, wmax), 10)
    # Per voxel: tsdf, weight, num, den, rgb (3), rgbnum (3) read; tsdf,
    # weight, rgb (3) written.
    nbytes = 60 * cap * 512
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    print(f"tsdf_combine cap={cap}: {ms:.4f} ms/launch, bound "
          f"{bound_ms:.4f} ms (bytes, {nbytes / 1e6:.1f} MB), plain "
          f"{plain_ms:.3f} ms, library yardstick: none", flush=True)
    return dict(name="tsdf_combine", route="cuda",
                source="structured_light_for_3d_model_replication_tpu_torch/"
                       "csrc/combine.cu",
                replaces="structured_light_for_3d_model_replication_tpu/ops/"
                         "tsdf_pallas.py:55",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=None)


def cylinder_cloud(n: int, seed: int):
    """The JAX bench's config 3 cloud (``bench.py:1088-1133``): a cylinder
    of radius 80 mm, 160 mm tall, 500 mm from the camera, 0.5 mm noise,
    from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, n)
    zz = rng.uniform(-80, 80, n)
    cloud = np.stack([80 * np.cos(theta), zz, 80 * np.sin(theta) + 500],
                     1).astype(np.float32)
    cloud += rng.normal(0, 0.5, cloud.shape).astype(np.float32)
    return cloud


def brick_exact(dev, pts, val, k: int, excl: bool, label: str):
    """``brick_knn_cells`` against its plain version on the kernel inputs
    that ``brick_knn`` builds for ``pts`` (default cell scale and budget):
    fails unless d² bits and ids are equal. Returns (max |kernel − plain|,
    (bricks, nbr, nnb))."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        brickknn_kernel as bk,
    )

    bricks, nbr, nnb, _, n_drop = bk.kernel_inputs(pts, val, k, 140,
                                                   len(pts) // 8 + 1024)
    d, i = bk.brick_knn_cells(bricks, nbr, nnb, k, excl)
    rd, ri = bk.brick_knn_cells_plain(bricks, nbr, nnb, k, excl)
    torch.cuda.synchronize()
    same_d = torch.equal(d.view(torch.int32), rd.view(torch.int32))
    same_i = torch.equal(i, ri)
    fin = torch.isfinite(rd)
    err = float((d[fin] - rd[fin]).abs().max()) if bool(fin.any()) else 0.0
    print(f"brick_knn_cells {label}: {bricks.shape[0]} occupied cells, "
          f"{int(n_drop)} points dropped by slot overflow; max |kernel - "
          f"plain| = {err:.3e}, d2 bits equal {same_d}, ids equal {same_i}",
          flush=True)
    if not (same_d and same_i):
        fail(f"brick_knn_cells disagrees with its plain version ({label})")
    return err, (bricks, nbr, nnb)


def brute_knn(pts, val, k: int, excl: bool, rows):
    """The k nearest valid points of each of ``rows``, by brute force over
    direct differences (the matmul expansion cancels at the clouds' ~500 mm
    offset and reorders near neighbours): (d² (R, k), ids (R, k)),
    ascending."""
    import torch

    dev = pts.device
    inf = torch.full((), float("inf"), device=dev)
    ds, ids = [], []
    for r0 in range(0, len(rows), 256):
        rr = rows[r0:r0 + 256]
        q = pts[rr]
        dx, dy, dz = (q[:, j:j + 1] - pts[None, :, j] for j in range(3))
        dd = torch.where(val[None], (dx * dx + dy * dy) + dz * dz, inf)
        if excl:
            dd[torch.arange(len(rr), device=dev), rr] = float("inf")
        d, i = torch.topk(dd, k, dim=1, largest=False)
        ds.append(d)
        ids.append(i)
    return torch.cat(ds), torch.cat(ids)


def knn_recall(ref, idx, nbv) -> float:
    """Share of the reference neighbour ids ``ref`` (R, k) that the
    neighbour lists ``idx`` / ``nbv`` (R, k) hold."""
    import torch

    got = torch.where(nbv, idx, torch.full((), -1, device=idx.device))
    hits = sum(float((got[r:r + 4096, :, None] == ref[r:r + 4096, None, :])
                     .any(2).sum()) for r in range(0, len(ref), 4096))
    return hits / ref.numel()


def check_brick_knn(dev):
    """``brick_knn_cells`` against its plain version on the same kernel
    inputs (the kernel path's set-up, ``brickknn_kernel.kernel_inputs``):
    at bench config 3b's shape (config 3's 2²⁰-point cylinder, k = 20,
    ``exclude_self``) and at a ragged cloud (100,003 points, 10% invalid,
    a 100-point clump that overflows its brick, k = 30, self included).
    Exact: d² bit-equal, ids equal. Then, at the first shape, the kernel
    timed beside its bound, the plain version and a library yardstick
    (``torch.cdist`` in its default matmul mode + ``torch.topk``, two
    calls, over the same gathered candidates); recall of ``brick_knn``
    against brute force on 4,096 sampled rows, by direct differences (the
    matmul expansion cancels at the cloud's 500 mm offset, ~0.03 mm² of
    d², enough to reorder near neighbours); and the
    ``brick_knn`` wall (set-up, kernel, gather, and the exact rescue pass,
    as bench 3b runs it) beside ``morton_knn``'s."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        brickknn,
        brickknn_kernel as bk,
        mortonknn,
    )

    rng = np.random.default_rng(3)
    ragged = cylinder_cloud(100_003, 1)
    ragged[-100:] = ragged[0] + 1.0          # the overflow clump
    ragged_valid = rng.random(len(ragged)) >= 0.1
    ragged_valid[-100:] = True
    cases = (("2^20-point cylinder (bench config 3), k=20, exclude_self",
              cylinder_cloud(BRICK_N, 0), None, 20, True),
             ("ragged 100,003 points, 10% invalid, clump, k=30, self "
              "included", ragged, ragged_valid, 30, False))
    main, max_err = None, 0.0
    for label, cloud, valid, k, excl in cases:
        pts = torch.from_numpy(cloud).to(dev)
        val = (torch.ones(len(cloud), dtype=torch.bool, device=dev)
               if valid is None else torch.from_numpy(valid).to(dev))
        err, inputs = brick_exact(dev, pts, val, k, excl, label)
        max_err = max(max_err, err)
        if main is None:
            main = (pts, val, *inputs, k, excl)
    pts, val, bricks, nbr, nnb, k, excl = main
    c = bricks.shape[0]
    ms = cuda_ms(lambda: bk.brick_knn_cells(bricks, nbr, nnb, k, excl), 20)
    plain_ms = cuda_ms(
        lambda: bk.brick_knn_cells_plain(bricks, nbr, nnb, k, excl), 2, 1)
    # Library yardstick over the same gathered candidates; absent neighbour
    # bricks point at a far-away dummy brick so they never rank.
    coords = bricks[..., :3].contiguous().view(torch.float32)
    coords = torch.where(torch.isfinite(coords), coords,
                         torch.full((), 1e6, device=dev))
    far = torch.full((1, 32, 3), 1e6, device=dev)
    slot = torch.arange(27, device=dev)
    nb_lib = torch.where(slot[None] < nnb[:, None], nbr.long(),
                         torch.full((), c, device=dev))
    cand = torch.cat([coords, far])[nb_lib].reshape(c, 27 * 32, 3)
    lib_ms = cuda_ms(lambda: torch.topk(torch.cdist(coords, cand), k, dim=2,
                                        largest=False), 5, 1)
    del cand
    # Bound, from what these inputs need: the live points once (16 B
    # each), the table and the counts, a k-wide output row (d², id) for
    # each live point; 8 fp32 operations for each pair of a live query and
    # a live candidate in one of its cell's present neighbour bricks.
    live = (bricks[..., 3] >= 0).sum(1)
    present = slot[None] < nnb[:, None]
    cand = torch.where(present, live[nbr.long().clamp(0, c - 1)],
                       torch.zeros((), dtype=live.dtype, device=dev)).sum(1)
    pairs = float((live.to(torch.float64) * cand.to(torch.float64)).sum())
    n_live = int(live.sum())
    flops = NN_FLOPS_PER_PAIR * pairs
    nbytes = n_live * 16 + c * 27 * 4 + c * 4 + n_live * k * 8
    t_ops = flops / H100_FP32_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    bound_ms, bound_by = max((t_ops, "operations"), (t_bytes, "bytes"))
    print(f"brick_knn_cells {c} cells, {n_live} live points, k={k}: "
          f"{ms:.4f} ms/launch, bound {bound_ms:.4f} ms ({bound_by}; "
          f"{pairs / 1e6:.1f} M live pairs, {flops / 1e9:.3f} GFLOP -> "
          f"{t_ops:.4f} ms; {nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms), "
          f"plain {plain_ms:.3f} ms, library torch.cdist + torch.topk (two "
          f"calls) {lib_ms:.3f} ms", flush=True)

    # Recall of the whole engine against brute force on 4,096 rows.
    d, i, v = brickknn.brick_knn(pts, k, points_valid=val, exclude_self=excl)
    rows = torch.from_numpy(np.sort(rng.choice(len(pts), 4096,
                                               replace=False))).to(dev)
    recall = knn_recall(brute_knn(pts, val, k, excl, rows)[1], i[rows],
                        v[rows])
    # Walls of the engines, each call ending in a synchronize.
    walls = {}
    for name, fn in (("brick_knn", lambda: brickknn.brick_knn(
            pts, k, exclude_self=excl, rescue=True, return_dropped=True)),
                     ("morton_knn", lambda: mortonknn.morton_knn(
                         pts, k, exclude_self=excl))):
        fn()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        walls[name] = best
    n_left = brickknn.brick_knn(pts, k, exclude_self=excl, rescue=True,
                                return_dropped=True)[3]
    print(f"brick_knn at 2^20, k={k}: recall {recall:.5f} against brute force"
          f" on 4096 rows; wall {walls['brick_knn'] * 1e3:.1f} ms (set-up + "
          f"kernel + gather + rescue pass, {n_left} rows still dropped) vs "
          f"morton_knn {walls['morton_knn'] * 1e3:.1f} ms: rescue_cost_ratio"
          f" {walls['brick_knn'] / walls['morton_knn']:.3f}", flush=True)
    if recall < 0.99:
        fail(f"brick_knn recall {recall:.5f} < 0.99 at 2^20 points")
    return dict(name="brick_knn_cells", route="cuda",
                source="structured_light_for_3d_model_replication_tpu_torch/"
                       "csrc/brick_knn.cu",
                replaces="structured_light_for_3d_model_replication_tpu/ops/"
                         "brickknn_pallas.py:380",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)


def composite_scene(dev):
    """A seeded splat scene at config 12's capacity (16,384 slots) on the
    card: the headline scene's spheres sampled as a coloured oriented cloud
    (points inside another sphere dropped), through
    ``splat_scene_from_cloud`` at grid depth 8."""
    from structured_light_for_3d_model_replication_tpu_torch.io.ply import (
        PointCloud,
    )
    from structured_light_for_3d_model_replication_tpu_torch.splat import (
        SplatParams,
        splat_scene_from_cloud,
    )

    rng = np.random.default_rng(12)
    spheres = headline_scene(None).spheres
    pts, nrm = [], []
    for s in spheres:
        d = rng.normal(size=(int(4.0 * np.pi * s.radius ** 2), 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        pts.append(np.asarray(s.center) + s.radius * d)
        nrm.append(d)
    pts, nrm = np.concatenate(pts), np.concatenate(nrm)
    outside = np.ones(len(pts), bool)
    for s in spheres:
        outside &= np.linalg.norm(pts - np.asarray(s.center), axis=1) \
            >= s.radius - 1e-3
    pts, nrm = pts[outside], nrm[outside]
    cols = np.clip(127.5 + 127.5 * np.sin(pts / 17.0), 0, 255)
    cloud = PointCloud(points=pts.astype(np.float32),
                       colors=cols.astype(np.uint8),
                       normals=nrm.astype(np.float32))
    return splat_scene_from_cloud(cloud, SplatParams(capacity=16_384),
                                  depth=8, max_bricks=16_384, device=dev)


def composite_agrees(planes, x0, y0, tile: int, label: str) -> float:
    """``composite_cells`` against its plain version on one set of
    records, to 1e-5 (the JAX package's tolerance between its two
    composite forms, tests/test_splat.py: the K-sum runs in another
    order); fails on a larger gap or a non-finite output. Returns the
    gap."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        splat_composite as sc,
    )

    got = sc.composite(*planes, x0, y0, tile)
    ref = sc.composite_reference(*planes, x0, y0, tile)
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(a).all()) for a in (*got, *ref))
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    print(f"composite_cells {label}: max |kernel - plain| = {err:.3e}, "
          f"outputs finite {finite}", flush=True)
    if not finite or not err <= 1e-5:
        fail(f"composite_cells disagrees with its plain version ({label})")
    return err


def composite_timing(recs, x0, y0, tile: int, label: str) -> dict:
    """Device milliseconds of ``composite_cells`` on one set of records
    (by the profiler: the kernel runs for less time than its wrapper's
    host work, so CUDA events around a loop of calls time the host; the
    call's time comes from the events), its plain version's, and its bound
    from these records: the ten planes read once, the tile origins, (rgb,
    alpha) per pixel written once, and every live (pixel, record) pair one
    fold step."""
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        splat_composite as sc,
    )

    ms, _ = profile_calls(lambda: sc.composite(*recs, x0, y0, tile), 200,
                          ("composite_cells",))
    call_ms = cuda_ms(lambda: sc.composite(*recs, x0, y0, tile), 200)
    plain_ms = cuda_ms(lambda: sc.composite_reference(*recs, x0, y0, tile),
                       20)
    n_tiles, kk = recs[0].shape
    t2 = tile ** 2
    live = int(recs[9].sum())
    nbytes = 40 * n_tiles * kk + 8 * n_tiles + 16 * n_tiles * t2
    pairs = live * t2
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = pairs * COMPOSITE_FLOPS_PER_PAIR / H100_FP32_FLOPS * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    print(f"composite_cells {label}: {n_tiles} tiles x K = {kk}, {live} of "
          f"{n_tiles * kk} slots live ({live / (n_tiles * kk):.4f}): "
          f"{ms:.4f} ms/launch on the device ({call_ms:.4f} ms a call with "
          f"the wrapper), bound {bound_ms:.4f} ms ({bound_by}; bytes "
          f"{bytes_ms:.4f} ms, {nbytes / 1e6:.2f} MB; operations "
          f"{ops_ms:.4f} ms, {pairs / 1e6:.2f} M live pairs x "
          f"{COMPOSITE_FLOPS_PER_PAIR}), plain {plain_ms:.3f} ms, library "
          f"yardstick: none (no single PyTorch call computes this "
          f"front-to-back fold)", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def check_composite(dev):
    """``composite_cells`` against its plain version at config 12's render
    (384×288, tile 8, K = 128, 1,728 tiles, records of a seeded 16,384-slot
    scene) and at a ragged shape (tile 16, K = 77, 1,009 tiles, half the
    slots masked), the ragged one also with NaN in every masked slot, and
    timed on the first. The splat path times it again on its own records
    (``splat_path``), and those numbers go into the ``kernels`` line."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        splat_composite as sc,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        splat_render as sr,
    )

    scene = composite_scene(dev)
    cfg = sr.RenderConfig()
    cam = sr.camera_tensors(scene.camera(30.0, 20.0, cfg.width, cfg.height),
                            dev)
    recs, x0, y0 = sr._tile_records(
        scene.means, scene.normals, scene.log_scales, scene.colors_sh,
        scene.opacity, scene.valid, *cam, cfg)

    g = torch.Generator(device=dev)
    g.manual_seed(7)
    nt, k, tile = 1009, 77, 16

    def u(lo, hi, shape=(nt, k)):
        return torch.rand(shape, device=dev, generator=g) * (hi - lo) + lo

    rx0 = torch.floor(u(0, 24, (nt,))) * tile
    ry0 = torch.floor(u(0, 18, (nt,))) * tile
    ca, cc = u(0.02, 0.5), u(0.02, 0.5)
    ragged = [rx0[:, None] + u(-6, tile + 6), ry0[:, None] + u(-6, tile + 6),
              ca, u(-0.9, 0.9) * torch.sqrt(ca * cc), cc, u(0, 1), u(0, 1),
              u(0, 1), u(0.05, 0.99), u(0, 1) < 0.5]
    poisoned = [torch.where(ragged[9], a, torch.full((), float("nan"),
                                                     device=dev))
                for a in ragged[:9]] + [ragged[9]]
    max_err = max(
        composite_agrees(recs, x0, y0, cfg.tile,
                         f"config 12 render, {int(recs[9].sum())} of "
                         f"{recs[0].numel()} slots live"),
        composite_agrees(ragged, rx0, ry0, tile,
                         "ragged, tile 16, K = 77, 1009 tiles"),
        composite_agrees(poisoned, rx0, ry0, tile,
                         "ragged with NaN in the masked slots"))
    ref_ragged = sc.composite_reference(*ragged, rx0, ry0, tile)
    if max(float((a - b).abs().max()) for a, b in zip(
            sc.composite(*poisoned, rx0, ry0, tile), ref_ragged)) > 1e-5:
        fail("composite_cells: NaN in masked slots changed the pixels")
    timing = composite_timing(recs, x0, y0, cfg.tile,
                              "on the sphere-cloud scene")
    return dict(name="composite_cells", route="cuda",
                source="structured_light_for_3d_model_replication_tpu_torch/"
                       "csrc/composite.cu",
                replaces="structured_light_for_3d_model_replication_tpu/ops/"
                         "splat_render_pallas.py:76",
                max_abs_err=max_err, library_ms=None, **timing)


# ---------------------------------------------------------------------------
# Phase 4: the main path at full size
# ---------------------------------------------------------------------------


def headline_scene(wall_z):
    """The headline bump scene: a sphere of radius 80 mm on the turntable
    axis with six bumps around it; ``wall_z`` the wall behind it (None: no
    wall, the 360° ring's setting; 700: the rig's default)."""
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        synthetic,
    )

    def bump(az_deg, y, r):
        az = np.radians(az_deg)
        return synthetic.Sphere(
            (90.0 * np.sin(az), y, 500.0 + 90.0 * np.cos(az)), r, 0.75)

    return synthetic.Scene(wall_z=wall_z, spheres=(
        synthetic.Sphere((0.0, 10.0, 500.0), 80.0, 0.9),
        bump(0, -40, 32), bump(60, 30, 26), bump(130, -10, 30),
        bump(200, 55, 24), bump(270, -55, 28), bump(320, 20, 22)))


def render_stop(scene, rig, h: int, w: int, proj):
    """One stop's (F, h, w) uint8 stack of ``scene``, frames shaded in
    parallel on the host."""
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        synthetic,
    )

    frames = synthetic.pattern_frames(proj)
    shader = synthetic.FrameShader(scene, *rig, h, w, proj)
    stack = np.empty((frames.shape[0], h, w), np.uint8)

    def shade(f):
        stack[f] = shader.shade(frames[f])

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        list(ex.map(shade, range(frames.shape[0])))
    return stack


def render_stacks(n_stops: int, step_deg: float, proj):
    """The headline bump scene, camera at the projector's resolution,
    rendered on the host with the port's numpy rig (untimed set-up).
    Returns (stacks, rig, ground-truth points of stop 0, scene)."""
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        synthetic,
    )

    h, w = proj.height, proj.width
    rig = synthetic.default_calibration(h, w, proj)
    scene = headline_scene(None)
    frames = synthetic.pattern_frames(proj)
    stacks = np.empty((n_stops, frames.shape[0], h, w), np.uint8)
    gts = [None] * n_stops

    def render(k):
        sc = synthetic.rotated_scene(scene, k * step_deg)
        shader = synthetic.FrameShader(sc, *rig, h, w, proj)
        for f in range(frames.shape[0]):
            stacks[k, f] = shader.shade(frames[f])
        gts[k] = shader.ground_truth["points"]

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        list(ex.map(render, range(n_stops)))
    return stacks, rig, gts[0], scene


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def profile_run(run, top: int = 15) -> None:
    """Run ``run()`` once under ``torch.profiler`` and print where the
    device time goes: kernel count, device-busy time (the union of kernel
    intervals) against the wall, and the kernels with the most device time.
    The counted main-path run is never profiled."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, cur_s, cur_e = 0.0, None, None
    per_name = {}
    for s0, e0, name in spans:
        n, t = per_name.get(name, (0, 0.0))
        per_name[name] = (n + 1, t + (e0 - s0))
        if cur_e is None or s0 > cur_e:
            busy_us += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    print(f"profile: {len(spans)} kernels, device busy {busy_us / 1e3:.1f} ms "
          f"of {wall_ms:.1f} ms wall under the profiler (idle share "
          f"{1 - busy_us / 1e3 / wall_ms:.3f})", flush=True)
    for name, (n, t) in sorted(per_name.items(), key=lambda kv: -kv[1][1])[
            :top]:
        print(f"  {t / 1e3:9.2f} ms {n:6d}x  {name[:100]}", flush=True)


def scan_params(step: float):
    """The 360° path's settings: the JAX bench's headline ring
    (``voxel_size=3.0``, ``view_cap=16_384``), sequential, six stops a
    decode launch."""
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        merge,
        scan360,
    )

    return scan360.Scan360Params(
        merge=merge.MergeParams(voxel_size=3.0, final_max_points=131_072,
                                step_deg=step),
        method="sequential", view_cap=16_384, stop_chunk=6)


def main_path(dev, n_stops: int, proj=None, profile: bool = False):
    """Drive ``scan_stacks_to_cloud`` once at full size (1920×1080
    projector unless ``proj`` says otherwise) and check what comes out;
    then run it again on the same stacks, which must give the same poses
    and merged cloud bit for bit and the same launch counts (that run also
    tallies the correspondence sweeps by shape and keeps the first sweep of
    each shape); with ``profile`` run it once more under the profiler. The
    mesh half (:func:`mesh_path`) follows. Returns the launch counts, the
    rendered ring (stacks, calibration, projector, scene) for the streaming
    phase, and the paths' kernel operands: ``{"nn": {(queries, keys):
    (sweeps, operands)}, "matvec": (x, W, nbr, block_valid)}``."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.config import (
        ProjectorConfig,
    )
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        pipeline,
        scan360,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        brickknn_kernel,
        decode,
        nn,
        splat_composite,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops.triangulate import (
        make_calibration,
    )

    proj = proj or ProjectorConfig()
    step = STEP_DEG
    t0 = time.perf_counter()
    stacks, rig, gt0, scene = render_stacks(n_stops, step, proj)
    h, w = stacks.shape[2:]
    print(f"rendered {n_stops} stops x {stacks.shape[1]} frames at {h}x{w} "
          f"in {time.perf_counter() - t0:.1f} s (untimed set-up)", flush=True)
    calib = make_calibration(*rig, h, w, proj.width, proj.height, device=dev)
    params = scan_params(step)

    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    decode.decode_maps.launches = 0
    nn.nearest_one.launches = 0
    brickknn_kernel.brick_knn_cells.launches = 0
    splat_composite.composite.launches = 0
    timing = {}
    t0 = time.perf_counter()
    merged, poses, stats = scan360.scan_stacks_to_cloud(
        stacks, calib, proj.col_bits, proj.row_bits, params=params,
        with_stats=True, timing=timing, device=dev)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = {"decode_maps": decode.decode_maps.launches,
                "nearest_one": nn.nearest_one.launches}
    brick = brickknn_kernel.brick_knn_cells.launches
    composite = splat_composite.composite.launches
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    print(f"main path: {n_stops} stops -> {len(merged)} points in "
          f"{wall:.3f} s wall; stages (s): " + ", ".join(
              f"{k}={v:.3f}" for k, v in timing.items()
              if k.endswith("_s")), flush=True)
    print(f"peak device memory {peak / 2**30:.2f} GiB; kernel launches "
          f"{dict(launches, brick_knn_cells=brick, composite_cells=composite)}",
          flush=True)
    worst = 0.0
    for k in range(n_stops):
        R = poses[k][:3, :3].astype(np.float64)
        ang = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))
        cmd = (k * step) % 360.0
        cmd = min(cmd, 360.0 - cmd)
        worst = max(worst, abs(ang - cmd))
        print(f"  pose {k:2d}: {ang:8.3f} deg vs commanded {cmd:6.1f}",
              flush=True)
    fits = [e["fitness"] for e in stats["edges"]]
    print(f"edge fitness min {min(fits):.4f} mean {np.mean(fits):.4f}; "
          f"worst pose error {worst:.3f} deg", flush=True)

    if worst > 2.0:
        fail(f"a pose is {worst:.3f} deg off its commanded angle")
    if len(merged) <= (10_000 if proj.width >= 1920 else 200):
        fail(f"merged cloud has only {len(merged)} points")
    if merged.colors is None or merged.normals is None:
        fail("merged cloud lacks colours or normals")
    if not np.isfinite(merged.points).all():
        fail("merged cloud has non-finite points")
    for name, count in launches.items():
        if count <= 0:
            fail(f"the main path never launched {name}")
    if brick != 0:
        fail(f"the 360° path launched brick_knn_cells {brick} times: its "
             "clouds stay below the brick engine's 131,072 points")
    if composite != 0:
        fail(f"the 360° path launched composite_cells {composite} times: "
             "it renders nothing")

    # Stop 0 triangulated against the rendered ground truth (the decode
    # rounds to the nearest projector column: ~1 pixel of depth).
    r = pipeline.reconstruct(stacks[0], calib, proj.col_bits, proj.row_bits,
                             device=dev)
    valid = r.valid.cpu().numpy()
    err = np.linalg.norm(r.points.cpu().numpy()[valid]
                         - gt0.reshape(-1, 3)[valid], axis=1)
    print(f"stop 0: {int(valid.sum())} valid pixels, median |p - truth| "
          f"{np.median(err):.3f} mm", flush=True)
    if valid.mean() < 0.05 or np.median(err) > 3.0:
        fail("stop 0 does not match the rendered ground truth")
    # Repeatability: the same stacks again must give the same bits; that
    # run tallies the correspondence sweeps by shape.
    _sync(dev)
    decode.decode_maps.launches = 0
    nn.nearest_one.launches = 0
    with sweep_tally() as sweeps:
        merged2, poses2 = scan360.scan_stacks_to_cloud(
            stacks, calib, proj.col_bits, proj.row_bits, params=params,
            device=dev)
    _sync(dev)
    same = {"poses": np.array_equal(np.asarray(poses), np.asarray(poses2)),
            "points": np.array_equal(merged.points, merged2.points),
            "colors": np.array_equal(merged.colors, merged2.colors),
            "normals": np.array_equal(merged.normals, merged2.normals),
            "launches": launches == {"decode_maps":
                                     decode.decode_maps.launches,
                                     "nearest_one": nn.nearest_one.launches}}
    print(f"repeat 360° path: bit-equal {same}; nearest_one sweeps by "
          f"(queries, keys): { {k: v[0] for k, v in sweeps.items()} }",
          flush=True)
    if not all(same.values()):
        fail(f"the 360° path gave other results on the same stacks: {same}")
    if profile:
        profile_run(lambda: scan360.scan_stacks_to_cloud(
            stacks, calib, proj.col_bits, proj.row_bits, params=params,
            device=dev))
    mesh_launches, band = mesh_path(dev, merged, scene, profile=profile)
    launches.update(mesh_launches)
    return (launches,
            dict(stacks=stacks, calib=calib, proj=proj, scene=scene),
            dict(nn=sweeps, matvec=band))


def surface_distance(points: np.ndarray, spheres) -> np.ndarray:
    """Distance of each point to the surface of the union of ``spheres``
    (exact outside the union)."""
    d = np.full(points.shape[0], np.inf)
    for s in spheres:
        d = np.minimum(d, np.linalg.norm(points - np.asarray(s.center),
                                         axis=1) - s.radius)
    return np.abs(d)


def mesh_path(dev, merged, scene, profile: bool = False):
    """The main path's second half: ``mesh_360`` of the merged cloud at
    depth 10 (trim 0, 100 CG iterations, the bench.py config 6 settings)
    into a temporary STL, with the mesh kernels' launch counters zeroed
    before and read after; stage times, band, mesh, peak memory, the STL
    read back and the vertices against the scene's analytic surface. Then
    the same cloud meshed again must give the same CG count, matvec
    launches and mesh, bit for bit; that run keeps the first matvec's
    operands (the path's band) and times the CG iterations on the device's
    clock (CUDA events at every matvec). Returns the launch counts and the
    band's operands (x, W, nbr, block_valid)."""
    import tempfile

    import torch

    from structured_light_for_3d_model_replication_tpu_torch.io.ply import (
        PointCloud,
    )
    from structured_light_for_3d_model_replication_tpu_torch.io.stl import (
        read_stl,
    )
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        meshing,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        brickknn_kernel,
        marching_classify,
        poisson_matvec,
        splat_composite,
    )

    def cloud():  # mesh_360 writes the oriented normals into its cloud
        return PointCloud(points=merged.points.copy(), colors=merged.colors,
                          normals=merged.normals.copy())

    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    poisson_matvec.matvec_band.launches = 0
    marching_classify.classify_cells.launches = 0
    brickknn_kernel.brick_knn_cells.launches = 0
    splat_composite.composite.launches = 0
    timing, stats = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.stl")
        t0 = time.perf_counter()
        mesh = meshing.mesh_360(cloud(), path, depth=10, quantile_trim=0.0,
                                cg_iters=100, timing=timing,
                                solve_stats=stats, device=dev)
        _sync(dev)
        wall = time.perf_counter() - t0
        launches = {"matvec_band": poisson_matvec.matvec_band.launches,
                    "classify_cells":
                        marching_classify.classify_cells.launches,
                    "brick_knn_cells":
                        brickknn_kernel.brick_knn_cells.launches,
                    "composite_cells": splat_composite.composite.launches}
        back = read_stl(path)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    print(f"mesh path: {len(merged)} points -> {len(mesh.vertices)} "
          f"vertices, {len(mesh.faces)} faces in {wall:.3f} s wall; stages "
          f"(s): " + ", ".join(f"{k}={v:.3f}" for k, v in timing.items()),
          flush=True)
    print(f"band {stats['n_blocks']} blocks; fine CG {stats['cg_iters_used']} "
          f"iterations (additive), coarse {stats['coarse_iters_used']}; peak "
          f"device memory {peak / 2**30:.2f} GiB; kernel launches {launches}",
          flush=True)
    dist = surface_distance(mesh.vertices.astype(np.float64),
                            synthetic_spheres(scene))
    med, p90 = float(np.median(dist)), float(np.percentile(dist, 90))
    print(f"mesh vertices vs the scene's surface: median {med:.3f} mm, p90 "
          f"{p90:.3f} mm (the watertight fill also caps unseen regions); "
          f"STL read back: {len(back.faces)} faces", flush=True)
    if launches["matvec_band"] != 1 + stats["cg_iters_used"]:
        fail(f"matvec_band launched {launches['matvec_band']} times, not "
             f"1 + {stats['cg_iters_used']} CG iterations")
    if launches["classify_cells"] != 1:
        fail(f"classify_cells launched {launches['classify_cells']} times, "
             "not once")
    if launches.pop("brick_knn_cells") != 0:
        fail("the mesh path launched brick_knn_cells: its cloud carries "
             "normals and stays below 131,072 points")
    if launches.pop("composite_cells") != 0:
        fail("the mesh path launched composite_cells: it renders nothing")
    if len(mesh.faces) <= 10_000:
        fail(f"the mesh has only {len(mesh.faces)} faces")
    if len(back.faces) != len(mesh.faces):
        fail("the STL does not read back to the same face count")
    if not np.isfinite(mesh.vertices).all() or med > 1.0:
        fail(f"the mesh is {med:.3f} mm from the scene's surface (median)")

    # Repeatability: the same cloud again must give the same bits.
    _sync(dev)
    poisson_matvec.matvec_band.launches = 0
    stats2 = {}
    with cg_matvecs(dev) as seen:
        mesh2 = meshing.mesh_360(cloud(), os.devnull, depth=10,
                                 quantile_trim=0.0, cg_iters=100,
                                 solve_stats=stats2, device=dev)
    _sync(dev)
    same = {"cg_iters_used":
            stats2["cg_iters_used"] == stats["cg_iters_used"],
            "matvec_launches":
                poisson_matvec.matvec_band.launches == launches["matvec_band"],
            "vertices": np.array_equal(mesh.vertices, mesh2.vertices),
            "faces": np.array_equal(mesh.faces, mesh2.faces)}
    per_iter = cg_iteration_ms(seen["events"])
    print(f"repeat mesh path: bit-equal {same}; fine CG "
          f"{stats2['cg_iters_used']} iterations, {per_iter:.4f} ms per CG "
          f"iteration on the device's clock (first to last matvec); first "
          f"run's fine CG stage {timing.get('fine_cg_s', float('nan')):.3f} "
          f"s", flush=True)
    if not all(same.values()):
        fail(f"the mesh path gave other results on the same cloud: {same}")
    if profile:
        profile_run(lambda: meshing.mesh_360(
            cloud(), os.devnull, depth=10, quantile_trim=0.0, cg_iters=100,
            device=dev))
    return launches, seen["band"]


def path_kernel_timings(ops) -> None:
    """``nearest_one`` at the 360° path's two most swept shapes and
    ``matvec_band`` on the mesh path's band, with the operands those paths
    gave them (:func:`main_path`), after the paths' counts were read."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        nn,
        poisson_matvec as pm,
    )

    top = sorted(ops["nn"].items(), key=lambda kv: -kv[1][0])[:2]
    for (m, n), (count, (q, kt, p2v)) in top:
        d2, idx = nn.nearest_one(q, kt, p2v)
        rd2, ridx = nn.nearest_one_reference(q, kt, p2v)
        same = bool(torch_equal_bits(d2, rd2) and (idx == ridx).all())
        print(f"nearest_one on the 360° path's sweep {m}x{n} ({count} "
              f"launches of that shape on the path): equal to the plain "
              f"version: {same}", flush=True)
        if not same:
            fail(f"nearest_one disagrees with its plain version on the "
                 f"path's {m}x{n} sweep")
        nn_timing(q, kt, p2v, "(the path's sweep)")
    x, W, nbr, bv = ops["matvec"]
    same = torch.equal(pm.matvec_band(x, W, nbr, bv),
                       pm.matvec_band_reference(x, W, nbr, bv))
    print(f"matvec_band on the mesh path's band: equal to the plain "
          f"version: {same}", flush=True)
    if not same:
        fail("matvec_band disagrees with its plain version on the mesh "
             "path's band")
    matvec_timing(x, W, nbr, bv, "mesh path's band")


def torch_equal_bits(a, b) -> bool:
    """Equal bit for bit (float32 as int32: -0 and +0 differ, NaNs must
    match)."""
    import torch

    return torch.equal(a.view(torch.int32), b.view(torch.int32))


# Op classes that add floats as atomics on the card, or whose order
# otherwise depends on timing there (PyTorch's list under
# ``torch.use_deterministic_algorithms``), watched on CUDA float tensors.
ATOMIC_CLASS_OPS = frozenset((
    "index_add", "index_add_", "scatter_add", "scatter_add_",
    "scatter_reduce", "scatter_reduce_", "index_put", "index_put_",
    "_index_put_impl_", "put", "put_", "index_reduce", "index_reduce_",
    "cumsum", "cumsum_", "cumprod", "cumprod_", "histc", "bincount",
    "embedding_dense_backward", "_embedding_bag", "segment_reduce",
    "_segment_reduce_backward", "kthvalue", "median", "nanmedian"))


def diagnose_determinism(dev) -> None:
    """One diagnostic run of the 360° path and the mesh path under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``: prints
    every warning it raises (the ops without a deterministic form), and
    every op of :data:`ATOMIC_CLASS_OPS` met on a CUDA float tensor, by
    count (deterministic mode silently swaps some of those for a
    deterministic form, so it does not name them). The mode is switched
    off again before this returns."""
    import collections
    import warnings

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from structured_light_for_3d_model_replication_tpu_torch.config import (
        ProjectorConfig,
    )
    from structured_light_for_3d_model_replication_tpu_torch.io.ply import (
        PointCloud,
    )
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        meshing,
        scan360,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops.triangulate import (
        make_calibration,
    )

    seen = collections.Counter()

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in ATOMIC_CLASS_OPS:
                t = next((a for a in args if isinstance(a, torch.Tensor)),
                         None)
                if t is not None and t.is_cuda and t.is_floating_point():
                    acc = (kwargs or {}).get("accumulate",
                                             args[3] if len(args) > 3
                                             and isinstance(args[3], bool)
                                             else None)
                    seen[f"{name}(accumulate={acc})" if acc is not None
                         else name] += 1
            return func(*args, **(kwargs or {}))

    proj = ProjectorConfig()
    stacks, rig, _, _ = render_stacks(N_STOPS, STEP_DEG, proj)
    h, w = stacks.shape[2:]
    calib = make_calibration(*rig, h, w, proj.width, proj.height, device=dev)
    for label in ("360° path", "mesh path"):
        seen.clear()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught, Watch():
                warnings.simplefilter("always")
                if label == "360° path":
                    merged, _ = scan360.scan_stacks_to_cloud(
                        stacks, calib, proj.col_bits, proj.row_bits,
                        params=scan_params(STEP_DEG), device=dev)
                else:
                    meshing.mesh_360(
                        PointCloud(points=merged.points.copy(),
                                   colors=merged.colors,
                                   normals=merged.normals.copy()),
                        os.devnull, depth=10, quantile_trim=0.0,
                        cg_iters=100, device=dev)
                _sync(dev)
        finally:
            torch.use_deterministic_algorithms(False)
        msgs = collections.Counter(str(m.message).splitlines()[0][:200]
                                   for m in caught)
        print(f"determinism diagnostic, {label}: ops of the atomic class on "
              f"CUDA float tensors {dict(seen)}", flush=True)
        for msg, count in msgs.items():
            print(f"  warning x{count}: {msg}", flush=True)
        if not msgs:
            print("  no warning", flush=True)


# ---------------------------------------------------------------------------
# Phase 5: the streaming path on the same ring
# ---------------------------------------------------------------------------


def rotation_deg(R: np.ndarray) -> float:
    """Rotation angle of a 3×3 rotation, degrees."""
    R = np.asarray(R, np.float64)
    return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1,
                                              1))))


def pose_error(poses: np.ndarray, step: float) -> float:
    """Worst |rotation angle of pose k − k·step| over the ring, degrees."""
    worst = 0.0
    for k in range(poses.shape[0]):
        ang = rotation_deg(poses[k][:3, :3])
        cmd = (k * step) % 360.0
        worst = max(worst, abs(ang - min(cmd, 360.0 - cmd)))
    return worst


def stream_params(representation: str):
    """Session T (``"tsdf"``) runs bench config 11's settings
    (bench.py:898-905) on the headline ring as they stand: the sequential
    finalize and the covisibility gate on. Session P (``"poisson"``, config
    6b's lane) runs the ``StreamParams`` default ``method="posegraph"``, so
    the loop edge and the full pose graph run on the card too, with the gate
    off: on this ring the gate skips stops 22 and 23, and the JAX package's
    pose-graph finalize then registers a 45° loop edge from a 15° hint and
    lands its cloud 14 mm off the surface, as the port's does
    (``scripts/torch_gate_witness.py``; ROADMAP Queue 3)."""
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        merge,
    )
    from structured_light_for_3d_model_replication_tpu_torch.stream import (
        StreamParams,
    )

    lane = dict(method="sequential") if representation == "tsdf" \
        else dict(method="posegraph", covis=False)
    return StreamParams(
        merge=merge.MergeParams(voxel_size=3.0, final_max_points=131_072,
                                step_deg=STEP_DEG),
        view_cap=16_384, model_cap=131_072, preview_points=16_384,
        preview_depth=6, final_depth=10, representation=representation,
        tsdf_grid_depth=8, tsdf_max_bricks=16_384, **lane)


def run_session(dev, ring, representation: str, counters):
    """24 × ``add_stop`` then ``finalize(overlap=True)``, the launch
    counters zeroed just before and read just after. Returns (session,
    finalize result, launches, [(stop, reason, overlap)] of the skipped)."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.stream import (
        IncrementalSession,
    )

    proj = ring["proj"]
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    sess = IncrementalSession(ring["calib"], proj.col_bits, proj.row_bits,
                              params=stream_params(representation),
                              scan_id=f"smoke-{representation}", device=dev)
    metas, first_preview_s, cg, skipped = [], None, [], []
    for k in range(N_STOPS):
        r = sess.add_stop(ring["stacks"][k])
        if not r.fused:
            skipped.append((k, r.reason, round(r.overlap or 0.0, 5)))
        if r.preview:
            metas.append(dict(sess.preview_meta))
            if first_preview_s is None:
                first_preview_s = time.perf_counter() - t0
            if sess.previewer.last_cg_iters is not None:
                cg.append(sess.previewer.last_cg_iters)
    t1 = time.perf_counter()
    fin = sess.finalize(mesh=True, overlap=True)
    _sync(dev)
    finalize_s = time.perf_counter() - t1
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    per_stop = [m["integrate_s"] + m["preview_s"] for m in metas]
    print(f"session {representation}: {sess.stops_fused} stops fused, "
          f"{sess.stops_skipped} skipped {skipped}; first preview "
          f"{first_preview_s:.3f}"
          f" s after the first add_stop; per-stop integrate + preview median "
          f"{np.median(per_stop):.4f} s (min {min(per_stop):.4f}, max "
          f"{max(per_stop):.4f}); preview faces per stop "
          f"{[m['faces'] for m in metas]}; "
          f"stops wall {t1 - t0:.3f} s, finalize {finalize_s:.3f} s; peak "
          f"device memory {peak / 2**30:.2f} GiB; kernel launches {launches}",
          flush=True)
    if cg:
        print(f"session {representation}: preview CG iterations {cg}",
              flush=True)
    if not metas or metas[0]["stops_fused"] != 1 or metas[0]["faces"] == 0:
        fail(f"session {representation}: no preview after the first stop")
    worst = pose_error(fin.poses, STEP_DEG)
    print(f"session {representation}: {len(fin.cloud)} cloud points, worst "
          f"final pose error {worst:.3f} deg, stats: " + json.dumps(
              {k: v for k, v in fin.stats.items() if k != "edges"}),
          flush=True)
    if sess.stops_fused + sess.stops_skipped != N_STOPS:
        fail(f"session {representation} handled "
             f"{sess.stops_fused + sess.stops_skipped} of {N_STOPS} stops")
    if worst > 2.0:
        fail(f"session {representation}: a final pose is {worst:.3f} deg "
             "off its commanded angle")
    if not fin.stats.get("overlap", {}).get("overlapped"):
        fail(f"session {representation}: the finalize mesh did not overlap "
             "the tail")
    for name in ("decode_maps", "nearest_one"):
        if launches[name] <= 0:
            fail(f"session {representation} never launched {name}")
    if launches["brick_knn_cells"] != 0:
        fail(f"session {representation} launched brick_knn_cells "
             f"{launches['brick_knn_cells']} times: its clouds stay below "
             "131,072 points")
    if launches["composite_cells"] != 0:
        fail(f"session {representation} launched composite_cells "
             f"{launches['composite_cells']} times: it renders nothing")
    return sess, fin, launches, skipped


def stream_path(dev, ring):
    """Sessions T (``"tsdf"``) and P (``"poisson"``) on the headline ring,
    then the overlap check on session T's cloud. Returns session T's
    launch counts."""
    import tempfile

    from structured_light_for_3d_model_replication_tpu_torch.io.ply import (
        PointCloud,
        read_ply_mesh,
        write_ply_mesh,
    )
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        meshing,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        decode,
        marching_classify,
        nn,
        poisson_matvec,
        splat_composite,
        tsdf_combine,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops.brickknn_kernel import (
        brick_knn_cells,
    )

    counters = {"decode_maps": decode.decode_maps,
                "nearest_one": nn.nearest_one,
                "matvec_band": poisson_matvec.matvec_band,
                "classify_cells": marching_classify.classify_cells,
                "tsdf_combine": tsdf_combine.tsdf_combine,
                "brick_knn_cells": brick_knn_cells,
                "composite_cells": splat_composite.composite}
    spheres = synthetic_spheres(ring["scene"])

    # Session T: the default lane at full width, the gate on.
    sess, fin, launches_t, skipped = run_session(dev, ring, "tsdf", counters)
    if [(k, why) for k, why, _ in skipped] != list(REFERENCE_SKIPS):
        fail(f"session tsdf skipped {skipped}, the JAX package's session on "
             f"this ring {list(REFERENCE_SKIPS)}")
    vol = sess.previewer.stats()
    print(f"session tsdf: volume {vol['bricks']} bricks of "
          f"{vol['max_bricks']} ({vol['bricks_wanted']} wanted), voxel "
          f"{vol['voxel_size']} mm", flush=True)
    mesh = fin.mesh
    dist = surface_distance(mesh.vertices.astype(np.float64), spheres)
    med, p90 = float(np.median(dist)), float(np.percentile(dist, 90))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.ply")
        write_ply_mesh(path, mesh)
        back = read_ply_mesh(path)
    print(f"session tsdf final mesh: {len(mesh.vertices)} vertices, "
          f"{len(mesh.faces)} faces, vertex colours "
          f"{mesh.vertex_colors is not None}; vs the scene's surface median "
          f"{med:.3f} mm, p90 {p90:.3f} mm; PLY read back {len(back.faces)} "
          f"faces, colours {back.vertex_colors is not None}", flush=True)
    if launches_t["tsdf_combine"] != sess.stops_fused + 1:
        fail(f"tsdf_combine launched {launches_t['tsdf_combine']} times, not "
             f"{sess.stops_fused} fused stops + 1 final mesh")
    if len(mesh.faces) <= 10_000 or mesh.vertex_colors is None:
        fail(f"session tsdf: final mesh of {len(mesh.faces)} faces, colours "
             f"{mesh.vertex_colors is not None}")
    if not np.isfinite(mesh.vertices).all() or med > 1.0:
        fail(f"session tsdf: the final mesh is {med:.3f} mm from the "
             "scene's surface (median)")
    if len(back.faces) != len(mesh.faces) or back.vertex_colors is None:
        fail("session tsdf: the PLY does not read back to the same mesh")

    # Overlap check: sequential twice, then the pipelined worker.
    def cloud():
        c = fin.cloud
        return PointCloud(points=c.points.copy(), colors=c.colors.copy(),
                          normals=c.normals.copy())

    kw = dict(representation="tsdf", depth=10, tsdf_max_bricks=16_384,
              device=dev)
    seq = [meshing.mesh_from_cloud(cloud(), **kw) for _ in range(2)]
    asy = meshing.mesh_from_cloud_async(cloud(), task_name="smoke", **kw)
    asy = asy.result()
    for label, a, b in (("seq vs seq", seq[0], seq[1]),
                        ("seq vs async", seq[0], asy)):
        same_shape = a.vertices.shape == b.vertices.shape \
            and a.faces.shape == b.faces.shape
        equal = same_shape and np.array_equal(a.vertices, b.vertices) \
            and np.array_equal(a.faces, b.faces) \
            and np.array_equal(a.vertex_colors, b.vertex_colors)
        gap = float(np.abs(a.vertices - b.vertices).max()) if same_shape \
            else float("nan")
        print(f"overlap check {label}: bit-equal {equal}; {len(a.faces)} vs "
              f"{len(b.faces)} faces, {len(a.vertices)} vs {len(b.vertices)}"
              f" vertices, max |vertex gap| {gap:.3e} mm", flush=True)
        if label == "seq vs seq":
            seq_equal = equal
        elif seq_equal and not equal:
            fail("mesh_from_cloud_async differs from mesh_from_cloud while "
                 "two sequential calls agree")

    # Session P: the "poisson" lane.
    sess_p, fin_p, launches_p, _ = run_session(dev, ring, "poisson",
                                               counters)
    solve = fin_p.stats.get("final_solve", {})
    dist = surface_distance(fin_p.mesh.vertices.astype(np.float64), spheres)
    med_p = float(np.median(dist))
    print(f"session poisson final mesh: {len(fin_p.mesh.faces)} faces, vs the"
          f" scene's surface median {med_p:.3f} mm, p90 "
          f"{np.percentile(dist, 90):.3f} mm; final solve {json.dumps(solve)}",
          flush=True)
    if not np.isfinite(fin_p.mesh.vertices).all() or med_p > 1.0:
        fail(f"session poisson: the final mesh is {med_p:.3f} mm from the "
             "scene's surface (median)")
    if solve.get("warm_start_blocks", 0) <= 0:
        fail("session poisson: the previews did not warm-start the final "
             "solve")
    if launches_p["matvec_band"] != 1 + solve["cg_iters_used"]:
        fail(f"session poisson: matvec_band launched "
             f"{launches_p['matvec_band']} times, not 1 + "
             f"{solve['cg_iters_used']}")
    if launches_p["classify_cells"] != 1 or launches_p["tsdf_combine"] != 0:
        fail(f"session poisson: classify_cells {launches_p['classify_cells']}"
             f" launches (want 1), tsdf_combine "
             f"{launches_p['tsdf_combine']} (want 0)")
    return launches_t


# ---------------------------------------------------------------------------
# Phase 5b: the splat appearance tier on the same ring
# ---------------------------------------------------------------------------

SPLAT_SWEEP = 20               # novel views of the orbit sweep (bench [12])
HELD_OUT = 23                  # the stop the fit never sees
# bench [12]'s quality gate on the held-out view (bench.py:1050). Neither
# package meets it on this ring: the renderer keeps each tile's 128
# nearest splats of a median ~650 (ROADMAP Queue 3), so it is printed.
PSNR_GATE_DB = 20.0
# What the held-out view is held to instead. On this ring the view is
# bimodal in both packages: the last digits of the registration move the
# fused shell's sub-voxel geometry, which decides which 128 of ~650 members
# a held-out tile keeps (scripts/torch_gate_witness.py --splat at the
# 1080×1920 camera). Readings: the JAX package 8.937–10.703 dB over session
# seeds 12, 0, 1, 2; the port 14.511–14.755 dB on the host and
# 9.612–15.125 dB on the H100; the unfitted scene 9.94–9.98 dB in both. The
# view cannot tell a fitted scene from an unfitted one here, so the floor
# sits below every reading and catches a broken render; the fit is held by
# the training views' mean.
HELDOUT_FLOOR_DB = 8.0


def splat_params(merge_params, **small):
    """Bench config 12 as written (bench.py:992-1000): the sequential
    finalize, ``view_cap`` as the ring's, 131,072 model slots, no mesh
    previews, the ``"splat"`` lane on a grid-depth-8 TSDF of 16,384 bricks,
    16,384 splats fitted 200 Adam steps against 8 frames; ``small``
    overrides fields for the small rig."""
    from structured_light_for_3d_model_replication_tpu_torch.stream import (
        StreamParams,
    )

    kw = dict(method="sequential", view_cap=16_384, model_cap=131_072,
              preview_every=0, final_depth=10, representation="splat",
              tsdf_grid_depth=8, tsdf_max_bricks=16_384, splat_cap=16_384,
              splat_fit_iters=200, splat_max_frames=8)
    kw.update(small)
    return StreamParams(merge=merge_params, **kw)


def heldout_view(sess, stack, calib, proj, label: int):
    """Stop ``label``'s predicted camera at the fit resolution, its render
    config, and that stop's captured, decode-valid RGB as the target and
    mask (bench config 12's quality gate renders this view)."""
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        scan360,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        splat_render as sr,
    )
    from structured_light_for_3d_model_replication_tpu_torch.splat import (
        fit as splat_fit,
    )

    mesher = sess.previewer
    _, cols, vals = scan360.decode_stop(stack, calib, proj.col_bits,
                                        proj.row_bits)
    h, w = stack.shape[1:]
    target, mask = splat_fit.frame_target(cols.cpu().numpy(),
                                          vals.cpu().numpy(), h, w,
                                          mesher.stride)
    fx, fy, cx, cy = mesher.intrinsics
    s = float(mesher.stride)
    cam = sr.stop_camera(sess._predict_pose(label), fx / s, fy / s, cx / s,
                         cy / s)
    cfg = sr.RenderConfig(width=target.shape[1], height=target.shape[0])
    return cam, cfg, target, mask


def splat_path(dev, ring):
    """Bench config 12 on the headline ring: stops 0–22 through a
    ``representation="splat"`` session's ``add_stop``, ``ensure_scene``
    (seed on the fused shell + the appearance fit), one untimed render,
    the 20-view orbit sweep at 384×288 and the held-out render from stop
    23's predicted camera against the captured RGB; then the 8 buffered
    training views, ``render_png`` decoded back and the scene through
    ``to_bytes``/``from_bytes``. The held-out PSNR must reach
    ``HELDOUT_FLOOR_DB`` and the training views must average 20 dB (bench
    [12]'s gate is printed, met or not). The launch counters
    are zeroed before and read after each step: the composite kernel must
    not run in the fit and must run once per render after it. After the
    counts are read, the kernel is held against its plain version on the
    records of one sweep view and of the held-out view, and timed on both.
    Returns its launch count (22) and the sweep view's error and timing."""
    import statistics

    import torch

    from structured_light_for_3d_model_replication_tpu_torch.io.png import (
        decode_png,
    )
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        merge,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        brickknn_kernel,
        decode,
        marching_classify,
        nn,
        poisson_matvec,
        splat_composite,
        tsdf_combine,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        splat_render as sr,
    )
    from structured_light_for_3d_model_replication_tpu_torch.splat import (
        SplatScene,
        psnr,
    )
    from structured_light_for_3d_model_replication_tpu_torch.stream import (
        IncrementalSession,
    )

    counters = {"decode_maps": decode.decode_maps,
                "nearest_one": nn.nearest_one,
                "matvec_band": poisson_matvec.matvec_band,
                "classify_cells": marching_classify.classify_cells,
                "tsdf_combine": tsdf_combine.tsdf_combine,
                "brick_knn_cells": brickknn_kernel.brick_knn_cells,
                "composite_cells": splat_composite.composite}

    def zero():
        _sync(dev)
        for fn in counters.values():
            fn.launches = 0

    def read():
        _sync(dev)
        return {name: fn.launches for name, fn in counters.items()}

    proj, calib, stacks = ring["proj"], ring["calib"], ring["stacks"]
    sp = splat_params(merge.MergeParams(voxel_size=3.0,
                                        final_max_points=131_072,
                                        step_deg=STEP_DEG))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    zero()
    t0 = time.perf_counter()
    sess = IncrementalSession(calib, proj.col_bits, proj.row_bits, params=sp,
                              scan_id="smoke-splat", device=dev)
    skipped = []
    for k in range(HELD_OUT):
        r = sess.add_stop(stacks[k])
        if not r.fused:
            skipped.append((k, r.reason, round(r.overlap or 0.0, 5)))
    stops_s = time.perf_counter() - t0
    ingest = read()
    mesher = sess.previewer

    zero()
    t0 = time.perf_counter()
    scene = mesher.ensure_scene()
    _sync(dev)
    build_s = time.perf_counter() - t0
    build = read()

    zero()
    t0 = time.perf_counter()
    mesher.render_image(0.0, 20.0)                     # untimed warm-up
    warm_s = time.perf_counter() - t0
    per_view = []
    for i in range(SPLAT_SWEEP):
        t0 = time.perf_counter()
        img = mesher.render_image(360.0 * i / SPLAT_SWEEP, 20.0)
        per_view.append(time.perf_counter() - t0)
    h_cam, h_cfg, h_target, h_mask = heldout_view(
        sess, stacks[HELD_OUT], calib, proj, HELD_OUT)
    psnr_db = psnr(scene.render_camera(h_cam, h_cfg)[0], h_target, h_mask)
    renders = read()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # The kernel on this path's own records, after its counts were read:
    # one sweep view and the held-out view, against the plain version, and
    # timed (the sweep view's numbers go into the kernels line).
    s_cfg = sr.RenderConfig(width=img.shape[1], height=img.shape[0])
    path_err, timing = 0.0, None
    for label, cam, cfg in (
            ("splat path, sweep view 0", scene.camera(0.0, 20.0, s_cfg.width,
                                                      s_cfg.height), s_cfg),
            (f"splat path, held-out stop {HELD_OUT}", h_cam, h_cfg)):
        recs, x0, y0 = sr._tile_records(
            scene.means, scene.normals, scene.log_scales, scene.colors_sh,
            scene.opacity, scene.valid, *sr.camera_tensors(cam, dev), cfg)
        path_err = max(path_err, composite_agrees(recs, x0, y0, cfg.tile,
                                                  label))
        t = composite_timing(recs, x0, y0, cfg.tile, label)
        timing = timing or t

    train = []
    for (target, mask), cam in zip(mesher._frames, mesher._cams):
        cfg = sr.RenderConfig(width=target.shape[1], height=target.shape[0])
        train.append(psnr(scene.render_camera(cam, cfg)[0], target, mask))
    train_db = float(np.mean(train))
    empty_db = psnr(np.broadcast_to(np.asarray(h_cfg.bg, np.float32) / 255.0,
                                    h_target.shape), h_target, h_mask)
    png, meta = mesher.render_png(45.0, 20.0)
    png_same = bool(np.array_equal(decode_png(png),
                                   mesher.render_image(45.0, 20.0)))
    clone = SplatScene.from_bytes(scene.to_bytes(), device=dev)
    bytes_same = bool(np.array_equal(clone.render(40.0, 10.0),
                                     scene.render(40.0, 10.0)))
    st = scene.fit_stats
    vol = mesher.volume.stats()
    view_s = statistics.median(per_view)
    print(f"session splat: {sess.stops_fused} stops fused, "
          f"{sess.stops_skipped} skipped {skipped}; stops wall "
          f"{stops_s:.3f} s; {len(mesher._frames)} frames buffered at "
          f"stride {mesher.stride} ({mesher._frames[0][1].shape[1]}x"
          f"{mesher._frames[0][1].shape[0]}); volume {vol['bricks']} bricks; "
          f"kernel launches {ingest}", flush=True)
    print(f"repeatability witness, splat path: {scene.n_splats} splats; "
          f"gate overlaps of the skipped stops {skipped}", flush=True)
    print(f"session splat: ensure_scene (seed + fit) {build_s:.3f} s: "
          f"{scene.n_splats} splats of {scene.capacity}, fit loss "
          f"{st['fit_loss_first']} -> {st['fit_loss_last']} in "
          f"{st['fit_iters']} steps over {st['fit_frames']} frames, fit "
          f"{st['fit_seconds']} s; kernel launches {build}", flush=True)
    print(f"session splat: first render {warm_s:.4f} s, then "
          f"{SPLAT_SWEEP} orbit views at {img.shape[1]}x{img.shape[0]} "
          f"median {view_s:.4f} s (min {min(per_view):.4f}, max "
          f"{max(per_view):.4f}); held-out stop {HELD_OUT} PSNR "
          f"{psnr_db:.3f} dB; peak device memory {peak / 2**30:.2f} GiB; "
          f"kernel launches {renders}", flush=True)
    print(f"session splat: the {len(train)} buffered training views "
          f"{[round(t, 3) for t in train]} dB, mean {train_db:.3f} dB; "
          f"bench [12]'s {PSNR_GATE_DB:.0f} dB held-out gate "
          f"{'met' if psnr_db >= PSNR_GATE_DB else 'NOT met'} "
          f"({psnr_db:.3f} dB; held to {HELDOUT_FLOOR_DB} dB; a render of "
          f"the background alone reads {empty_db:.3f} dB)", flush=True)
    print(f"session splat: render_png {len(png)} bytes decodes to the "
          f"render: {png_same}; scene npz {len(scene.to_bytes())} bytes "
          f"renders the same pixels after from_bytes: {bytes_same}",
          flush=True)
    if ingest["composite_cells"] != 0 or build["composite_cells"] != 0:
        fail(f"session splat: composite_cells launched "
             f"{ingest['composite_cells']} times while ingesting and "
             f"{build['composite_cells']} in the fit (want 0 and 0)")
    if ingest["decode_maps"] != HELD_OUT \
            or ingest["tsdf_combine"] != sess.stops_fused \
            or ingest["nearest_one"] <= 0:
        fail(f"session splat: ingest launches {ingest}")
    want = 2 + SPLAT_SWEEP
    if renders["composite_cells"] != want:
        fail(f"session splat: composite_cells launched "
             f"{renders['composite_cells']} times, not one per render "
             f"({want})")
    if scene.n_splats < 0.5 * scene.capacity:
        fail(f"session splat: only {scene.n_splats} splats seeded")
    if not st["fit_loss_last"] < st["fit_loss_first"]:
        fail("session splat: the fit did not lower its loss")
    if img.shape != (288, 384, 3):
        fail(f"session splat: a view of shape {img.shape}")
    if not psnr_db >= HELDOUT_FLOOR_DB:
        fail(f"session splat: held-out PSNR {psnr_db:.3f} dB below "
             f"{HELDOUT_FLOOR_DB} dB")
    if not train_db >= PSNR_GATE_DB:
        fail(f"session splat: the training views average {train_db:.3f} "
             f"dB, below {PSNR_GATE_DB:.0f} dB")
    if not (png_same and bytes_same and meta["splats"] == scene.n_splats):
        fail("session splat: the PNG or the npz round trip changed the "
             "render")
    return renders["composite_cells"], dict(max_abs_err=path_err, **timing)


# ---------------------------------------------------------------------------
# Phase 6: the cleanup path on one capture-size stop with its wall
# ---------------------------------------------------------------------------


def _row_mask(points: np.ndarray, kept: np.ndarray) -> np.ndarray:
    """Rows of ``points`` that survive, by exact coordinates, in ``kept``."""
    view = np.dtype((np.void, 12))
    return np.isin(np.ascontiguousarray(points, np.float32).view(view)
                   .ravel(),
                   np.ascontiguousarray(kept, np.float32).view(view).ravel())


def cleanup_path(dev, proj=None, depth: int = 10) -> int:
    """The reference's Process tab (``cli mesh --remove-background
    --remove-outliers``) on one 1080×1920 stop of the headline bump scene
    with the rig's default wall at z = 700: ``reconstruct`` →
    ``to_point_cloud`` → PLY written and read back → ``remove_background``
    → ``remove_outliers`` → ``reconstruct_stl(depth=10)`` into a temporary
    STL, read back; the kernels' launch counters zeroed before and read
    after. Both KNN sweeps of this path (the outlier removal's k = 20 and
    the missing normals' k = 30) run at more than 131,072 points, so each
    takes the brick kernel once. Returns its launch count."""
    import tempfile

    import torch
    from scipy.spatial import cKDTree

    from structured_light_for_3d_model_replication_tpu_torch.config import (
        ProjectorConfig,
    )
    from structured_light_for_3d_model_replication_tpu_torch.io.ply import (
        read_ply,
        write_ply,
    )
    from structured_light_for_3d_model_replication_tpu_torch.io.stl import (
        read_stl,
    )
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        merge,
        meshing,
        pipeline,
        synthetic,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        brickknn_kernel,
        marching_classify,
        poisson_matvec,
        splat_composite,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops.triangulate import (
        make_calibration,
    )

    proj = proj or ProjectorConfig()
    h, w = proj.height, proj.width
    rig = synthetic.default_calibration(h, w, proj)
    scene = synthetic.rotated_scene(headline_scene(700.0), 0.0)
    t0 = time.perf_counter()
    stack = render_stop(scene, rig, h, w, proj)
    print(f"cleanup: rendered one stop with the wall at z = 700, "
          f"{stack.shape[0]} frames at {h}x{w}, in "
          f"{time.perf_counter() - t0:.1f} s (untimed set-up)", flush=True)
    calib = make_calibration(*rig, h, w, proj.width, proj.height, device=dev)
    counters = {"brick_knn_cells": brickknn_kernel.brick_knn_cells,
                "matvec_band": poisson_matvec.matvec_band,
                "classify_cells": marching_classify.classify_cells,
                "composite_cells": splat_composite.composite}
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters.values():
        fn.launches = 0
    stages, plane_stats, solve, mesh_timing = {}, {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()

        def lap(name):
            nonlocal t
            _sync(dev)
            now = time.perf_counter()
            stages[name] = now - t
            t = now

        res = pipeline.reconstruct(stack, calib, proj.col_bits,
                                   proj.row_bits, device=dev)
        cloud = pipeline.to_point_cloud(res)
        lap("reconstruct_s")
        ply_path = os.path.join(tmp, "stop.ply")
        write_ply(ply_path, cloud)
        cloud = read_ply(ply_path)
        lap("ply_s")
        bg = merge.remove_background(cloud, stats=plane_stats, device=dev)
        lap("background_s")
        clean = merge.remove_outliers(bg, device=dev)
        lap("outliers_s")
        stl_path = os.path.join(tmp, "model.stl")
        mesh = meshing.reconstruct_stl(clean, stl_path, depth=depth,
                                       timing=mesh_timing, solve_stats=solve,
                                       device=dev)
        lap("mesh_s")
        launches = {name: fn.launches for name, fn in counters.items()}
        back = read_stl(stl_path)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    print(f"cleanup: points {len(cloud)} captured -> {len(bg)} after the "
          f"background -> {len(clean)} after the outliers; mesh "
          f"{len(mesh.vertices)} vertices, {len(mesh.faces)} faces; wall "
          f"{sum(stages.values()):.3f} s; stages (s): " + ", ".join(
              f"{k}={v:.3f}" for k, v in stages.items()) + "; mesh stages "
          f"(s): " + ", ".join(f"{k}={v:.3f}" for k, v in mesh_timing.items())
          + f"; band {solve.get('n_blocks')} blocks, fine CG "
          f"{solve.get('cg_iters_used')}; peak device memory "
          f"{peak / 2**30:.2f} GiB; kernel launches {launches}", flush=True)

    # The plane: the wall's normal ±z and its offset 700 mm.
    plane = np.asarray(plane_stats["plane"], np.float64)
    tilt = float(np.degrees(np.arccos(min(1.0, abs(plane[2])
                                          / np.linalg.norm(plane[:3])))))
    z0 = -plane[3] / plane[2]
    on_wall = np.abs(clean.points[:, 2] - 700.0) < 10.0
    spheres = scene.spheres
    near = surface_distance(cloud.points.astype(np.float64), spheres) <= 2.0
    kept = _row_mask(cloud.points, clean.points)
    survive = float(kept[near].mean()) if near.any() else 0.0
    pts = clean.points.astype(np.float64)
    voxel = 1.2 * float((pts.max(0) - pts.min(0)).max()) / (2 ** depth - 1)
    gap = cKDTree(pts).query(mesh.vertices.astype(np.float64),
                             distance_upper_bound=2 * voxel)[0]
    close = np.isfinite(gap)
    med = float(np.median(surface_distance(
        mesh.vertices[close].astype(np.float64), spheres))) \
        if close.any() else float("inf")
    n_inl = plane_stats["inliers"]
    print(f"cleanup: plane {np.round(plane, 5).tolist()} ({n_inl} "
          f"inliers): tilt {tilt:.4f} deg, z = {z0:.3f} mm; "
          f"{on_wall.mean():.5f} of the survivors within 10 mm of the wall; "
          f"{survive:.5f} of the {int(near.sum())} points within 2 mm of "
          f"the spheres survive both passes; {int(close.sum())} mesh "
          f"vertices within two voxels ({2 * voxel:.3f} mm) of the cleaned "
          f"cloud, median {med:.4f} mm from the spheres; STL read back: "
          f"{len(back.faces)} faces", flush=True)
    cleanup_engines(dev, bg, clean, spheres)
    if tilt > 1.0 or abs(z0 - 700.0) > 2.0:
        fail(f"cleanup: the plane is {tilt:.3f} deg and {z0 - 700.0:.3f} mm "
             "off the wall")
    if on_wall.mean() >= 0.005:
        fail(f"cleanup: {on_wall.mean():.4f} of the survivors lie on the "
             "wall")
    if survive < 0.95:
        fail(f"cleanup: only {survive:.4f} of the sphere points survive")
    if launches["brick_knn_cells"] != 2:
        fail(f"cleanup: brick_knn_cells launched "
             f"{launches['brick_knn_cells']} times, not 2 (outliers k = 20, "
             "normals k = 30)")
    if launches["matvec_band"] != 1 + solve.get("cg_iters_used", -1) \
            or launches["classify_cells"] != 1:
        fail(f"cleanup: matvec_band {launches['matvec_band']} launches (want"
             f" 1 + {solve.get('cg_iters_used')}), classify_cells "
             f"{launches['classify_cells']} (want 1)")
    if launches["composite_cells"] != 0:
        fail(f"cleanup: composite_cells launched "
             f"{launches['composite_cells']} times: the path renders nothing")
    if len(mesh.faces) <= 10_000 or len(back.faces) != len(mesh.faces):
        fail(f"cleanup: the mesh has {len(mesh.faces)} faces, "
             f"{len(back.faces)} read back")
    if not np.isfinite(mesh.vertices).all() or med > 1.0:
        fail(f"cleanup: the mesh is {med:.3f} mm from the spheres (median)")
    return launches["brick_knn_cells"]


def cleanup_engines(dev, bg, clean, spheres) -> None:
    """After the cleanup path's counts were read: the brick kernel against
    its plain version on the two inputs that path gave it (the outlier
    removal's padded k = 20 sweep without self, the normals' k = 30 sweep
    of the cleaned cloud), then, with the exact neighbours by brute force,
    the ``dense`` engine, ``morton`` (the port's route at this size before
    the brick kernel) and ``rescue`` (the path's), each sweep's recall, the
    outlier keep mask and the normals, compared pair by pair."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.models import (
        merge,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        pointcloud,
    )

    pts_p, val_p = merge._pad_cloud(bg.points, dev)
    pts_c = torch.from_numpy(np.asarray(clean.points, np.float32)).to(dev)
    val_c = torch.ones(len(pts_c), dtype=torch.bool, device=dev)
    brick_exact(dev, pts_p, val_p, 20, True,
                f"cleanup outliers ({len(bg)} points padded to "
                f"{len(pts_p)}, k=20, exclude_self)")
    brick_exact(dev, pts_c, val_c, 30, False,
                f"cleanup normals ({len(pts_c)} points, k=30, self "
                "included)")

    # The exact neighbours of every point, then each engine's two sweeps:
    # recall against them, the SOR keep mask by the 2σ rule of
    # ``statistical_outlier_removal`` (the path's rescue mask is rebuilt
    # too, as a check of the rule), the normals from the k = 30 sweep.
    def sor_keep(d2, nbv, valid):
        mean_d = torch.where(nbv, torch.sqrt(d2), torch.zeros((), device=dev)
                             ).sum(1) / nbv.sum(1).clamp_min(1)
        keep, decidable = pointcloud._sor_mask(mean_d, nbv.sum(1) > 0, valid,
                                               2.0)
        return torch.where(decidable.any(), keep, valid).cpu().numpy()

    sweeps = (("SOR", pts_p, val_p, 20, True, len(bg)),
              ("normals", pts_c, val_c, 30, False, len(pts_c)))
    nbs = {}
    _sync(dev)
    t = time.perf_counter()
    for name, p, v, k, excl, n in sweeps:
        d2, idx = brute_knn(p, v, k, excl, torch.arange(n, device=dev))
        pad = len(p) - n
        nbs[name, "exact"] = (
            torch.cat([d2, d2.new_zeros((pad, k))]),
            torch.cat([idx, idx.new_zeros((pad, k))]),
            v[:, None] & torch.isfinite(torch.cat([d2, d2.new_zeros((pad, k))
                                                   ])))
    _sync(dev)
    secs = {"exact": time.perf_counter() - t}
    methods = ("dense", "morton", "rescue")
    for m in methods:
        t = time.perf_counter()
        for name, p, v, k, excl, _ in sweeps:
            nbs[name, m] = pointcloud._self_knn(p, k, v, excl, m)
        _sync(dev)
        secs[m] = time.perf_counter() - t
    engines = ("exact",) + methods
    keep = {m: sor_keep(*nbs["SOR", m][::2], val_p)[:len(bg)]
            for m in engines}
    nrm = {m: pointcloud.estimate_normals(pts_c, k=30,
                                          neighbors=nbs["normals", m])[0]
           for m in engines}
    rec = {(name, m): knn_recall(nbs[name, "exact"][1][:n], nbs[name, m][1][:n],
                                 nbs[name, m][2][:n])
           for name, _, _, _, _, n in sweeps for m in methods}
    near = surface_distance(bg.points.astype(np.float64), spheres) <= 2.0
    path_keep = _row_mask(bg.points, clean.points)
    print(f"cleanup engines on {dev.type}: SOR (k = 20) on {len(bg)} points "
          f"kept " + ", ".join(
              f"{m} {int(keep[m].sum())} ({float(keep[m][near].mean()):.5f}"
              f" of the {int(near.sum())} within 2 mm of the spheres)"
              for m in engines)
          + f"; the path's mask equals rescue's: "
          f"{bool(np.array_equal(path_keep, keep['rescue']))}; recall "
          f"against the exact neighbours of every point, SOR k = 20 / "
          f"normals k = 30: " + ", ".join(
              f"{m} {rec['SOR', m]:.5f} / {rec['normals', m]:.5f}"
              for m in methods)
          + "; seconds for both sweeps: " + ", ".join(
              f"{m} {secs[m]:.2f}" for m in engines), flush=True)
    for i, a in enumerate(engines):
        for b in engines[i + 1:]:
            dis = keep[a] != keep[b]
            cos = torch.nan_to_num((nrm[a] * nrm[b]).sum(1).abs(),
                                   nan=0.0).clamp(max=1.0)
            ang = torch.rad2deg(torch.acos(cos)).cpu().numpy()
            print(f"cleanup engines {a} vs {b}: SOR keep masks disagree on "
                  f"{int(dis.sum())} of {len(bg)} points "
                  f"({int(dis[near].sum())} of them within 2 mm of the "
                  f"spheres); normals (k = 30, {len(pts_c)} points) differ "
                  f"by > 1 deg on {int((ang > 1.0).sum())}, > 10 deg on "
                  f"{int((ang > 10.0).sum())}, median {np.median(ang):.4f} "
                  "deg", flush=True)


def synthetic_spheres(scene):
    """The scene's spheres in the merged cloud's frame (stop 0)."""
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        synthetic,
    )

    return synthetic.rotated_scene(scene, 0.0).spheres


def small_rig_agreement(dev) -> None:
    """The whole slice on the card against the same slice on the host (the
    plain versions): the tests' 4-stop, 10° rig (256×128 projector, 96×160
    camera, FAST parameters). The RANSAC streams of the two devices differ,
    so outcomes are compared: every pose within 0.5° of the host's and of
    i·10°, merged point counts within 5%."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.config import (
        ProjectorConfig,
    )
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        merge,
        scan360,
        synthetic,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops.triangulate import (
        make_calibration,
    )

    proj = ProjectorConfig(width=256, height=128)
    h, w = 96, 160
    rig = synthetic.default_calibration(h, w, proj)
    scene = synthetic.Scene(wall_z=None, spheres=tuple(
        synthetic.Sphere(c, r, a) for c, r, a in (
            ((0.0, 10.0, 500.0), 80.0, 0.9), ((60.0, -40.0, 460.0), 35.0, 0.7),
            ((-70.0, 40.0, 530.0), 30.0, 0.8),
            ((20.0, 70.0, 440.0), 25.0, 0.75))))
    stacks = np.stack([s for s, _ in synthetic.render_turntable_scans(
        scene, 4, 10.0, *rig, h, w, proj)])
    params = scan360.Scan360Params(merge=merge.MergeParams(
        voxel_size=6.0, ransac_iterations=2048, icp_iterations=20,
        fpfh_max_nn=32, normals_k=12, max_points=2048), view_cap=8192)
    runs = {}
    for d in (dev, torch.device("cpu")):
        calib = make_calibration(*rig, h, w, proj.width, proj.height,
                                 device=d)
        runs[d.type] = scan360.scan_stacks_to_cloud(
            stacks, calib, proj.col_bits, proj.row_bits, params=params,
            device=d)
    (m_dev, p_dev), (m_cpu, p_cpu) = runs[dev.type], runs["cpu"]
    worst = 0.0
    for i in range(4):
        a = [np.degrees(np.arccos(np.clip((np.trace(p[i][:3, :3]) - 1) / 2,
                                          -1, 1))) for p in (p_dev, p_cpu)]
        worst = max(worst, abs(a[0] - a[1]), abs(a[0] - 10.0 * i))
    print(f"small rig, {dev.type} vs cpu: {len(m_dev)} vs {len(m_cpu)} "
          f"merged points, worst pose gap {worst:.4f} deg", flush=True)
    if worst > 0.5 or abs(len(m_dev) - len(m_cpu)) > 0.05 * len(m_cpu):
        fail(f"the slice on {dev.type} disagrees with the host run")

    # On to the mesh at depth 9 on each device, compared by outcome (the
    # clouds differ by their RANSAC draws and the sums' order):
    # face counts within 3%, median vertex-to-vertex distance between the
    # two meshes ≤ 0.25 voxel. A block budget near the band's ~14k blocks
    # keeps the host run's fields small (every field spans the budget).
    from scipy.spatial import cKDTree

    from structured_light_for_3d_model_replication_tpu_torch.models import (
        meshing,
    )

    meshes = {}
    for d, m in ((dev, m_dev), (torch.device("cpu"), m_cpu)):
        t0 = time.perf_counter()
        meshes[d.type] = meshing.mesh_from_cloud(
            m, depth=9, quantile_trim=0.0, cg_iters=100, max_blocks=32_768,
            device=d)
        print(f"small rig mesh on {d.type}: {len(meshes[d.type].faces)} "
              f"faces in {time.perf_counter() - t0:.2f} s", flush=True)
    a, b = meshes[dev.type], meshes["cpu"]
    pts = np.asarray(m_cpu.points, np.float64)
    voxel = 1.2 * float((pts.max(0) - pts.min(0)).max()) / (2 ** 9 - 1)
    gap = np.concatenate([cKDTree(b.vertices).query(a.vertices)[0],
                          cKDTree(a.vertices).query(b.vertices)[0]])
    med = float(np.median(gap)) / voxel
    print(f"small rig mesh, {dev.type} vs cpu: {len(a.faces)} vs "
          f"{len(b.faces)} faces, median vertex gap {med:.4f} voxel",
          flush=True)
    if abs(len(a.faces) - len(b.faces)) > 0.03 * len(b.faces) or med > 0.25:
        fail(f"the mesh on {dev.type} disagrees with the host run")
    small_rig_stream(dev, stacks, rig, proj)
    small_rig_splat(dev, stacks, rig, proj)
    small_rig_brick_ring(dev, stacks, rig, proj, params)
    small_rig_cleanup(dev, rig, proj, scene)


def small_rig_splat(dev, stacks, rig, proj) -> None:
    """A 4-stop splat session on the small rig, on the card and on the host
    (the plain composite), compared by outcome: equal splat counts, and
    the PSNR of the render from the first stop's camera against its frame
    within 0.5 dB."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.models import (
        merge,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        splat_render as sr,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops.triangulate import (
        make_calibration,
    )
    from structured_light_for_3d_model_replication_tpu_torch.splat import (
        psnr,
    )
    from structured_light_for_3d_model_replication_tpu_torch.stream import (
        IncrementalSession,
    )

    h, w = stacks.shape[2:]
    sp = splat_params(
        merge.MergeParams(voxel_size=6.0, ransac_iterations=2048,
                          icp_iterations=20, fpfh_max_nn=32, normals_k=12,
                          max_points=2048, posegraph_iterations=20,
                          step_deg=10.0, final_max_points=4096),
        view_cap=8192, model_cap=32_768, window=3, final_depth=8,
        tsdf_grid_depth=6, tsdf_max_bricks=1024, splat_cap=4096,
        splat_fit_iters=40)
    out = {}
    for d in (dev, torch.device("cpu")):
        calib = make_calibration(*rig, h, w, proj.width, proj.height,
                                 device=d)
        sess = IncrementalSession(calib, proj.col_bits, proj.row_bits,
                                  params=sp, device=d)
        for k in range(stacks.shape[0]):
            sess.add_stop(stacks[k])
        mesher = sess.previewer
        scene = mesher.ensure_scene()
        target, mask = mesher._frames[0]
        cfg = sr.RenderConfig(width=target.shape[1], height=target.shape[0])
        img, _ = scene.render_camera(mesher._cams[0], cfg)
        out[d.type] = (scene.n_splats, psnr(img, target, mask))
    (n_d, p_d), (n_c, p_c) = out[dev.type], out["cpu"]
    print(f"small rig splat session, {dev.type} vs cpu: {n_d} vs {n_c} "
          f"splats, stop-0 view PSNR {p_d:.3f} vs {p_c:.3f} dB", flush=True)
    if n_d != n_c or abs(p_d - p_c) > 0.5:
        fail(f"the splat session on {dev.type} disagrees with the host run")


def small_rig_brick_ring(dev, stacks, rig, proj, params) -> None:
    """The small rig's ring with ``fpfh_engine="brick"``, on the card and on
    the host: every pose within 0.5° of the host's and of i·10°."""
    import dataclasses

    import torch

    from structured_light_for_3d_model_replication_tpu_torch.models import (
        scan360,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops.triangulate import (
        make_calibration,
    )

    h, w = stacks.shape[2:]
    params = dataclasses.replace(params, merge=dataclasses.replace(
        params.merge, fpfh_engine="brick"))
    poses = {}
    for d in (dev, torch.device("cpu")):
        calib = make_calibration(*rig, h, w, proj.width, proj.height,
                                 device=d)
        poses[d.type] = scan360.scan_stacks_to_cloud(
            stacks, calib, proj.col_bits, proj.row_bits, params=params,
            device=d)[1]
    worst = max(max(rotation_deg(a[:3, :3] @ b[:3, :3].T),
                    abs(rotation_deg(a[:3, :3]) - 10.0 * i))
                for i, (a, b) in enumerate(zip(poses[dev.type],
                                               poses["cpu"])))
    print(f"small rig ring, brick FPFH, {dev.type} vs cpu: worst pose gap "
          f"{worst:.4f} deg", flush=True)
    if worst > 0.5:
        fail(f"the brick-FPFH ring on {dev.type} disagrees with the host "
             "run")


def small_rig_cleanup(dev, rig, proj, scene) -> None:
    """The cleanup path at the small rig's size (one stop with the wall at
    z = 700): ``remove_background`` and ``remove_outliers`` on the card and
    on the host from the same PLY cloud, keep masks ≥ 99% equal (the
    RANSAC draws of the two devices differ)."""
    import dataclasses

    import torch

    from structured_light_for_3d_model_replication_tpu_torch.models import (
        merge,
        pipeline,
        synthetic,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops.triangulate import (
        make_calibration,
    )

    h, w = 96, 160
    walled = synthetic.rotated_scene(dataclasses.replace(scene, wall_z=700.0),
                                     0.0)
    stack = render_stop(walled, rig, h, w, proj)
    calib = make_calibration(*rig, h, w, proj.width, proj.height,
                             device="cpu")
    cloud = pipeline.to_point_cloud(pipeline.reconstruct(
        stack, calib, proj.col_bits, proj.row_bits, device="cpu"))
    masks = {}
    for d in (dev, torch.device("cpu")):
        bg = merge.remove_background(cloud, device=d)
        clean = merge.remove_outliers(bg, device=d)
        masks[d.type] = (_row_mask(cloud.points, bg.points),
                         _row_mask(cloud.points, clean.points))
    agree = [float((a == b).mean()) for a, b in zip(masks[dev.type],
                                                     masks["cpu"])]
    print(f"small rig cleanup, {dev.type} vs cpu: {len(cloud)} points, "
          f"{int(masks[dev.type][0].sum())} vs {int(masks['cpu'][0].sum())} "
          f"after the background, {int(masks[dev.type][1].sum())} vs "
          f"{int(masks['cpu'][1].sum())} after the outliers; keep masks "
          f"agree {agree[0]:.5f} / {agree[1]:.5f}", flush=True)
    if min(agree) < 0.99:
        fail(f"the cleanup path on {dev.type} disagrees with the host run")


def small_rig_stream(dev, stacks, rig, proj) -> None:
    """A 4-stop TSDF-lane session on the small rig, on the card and on the
    host, compared by outcome: fused stops equal, poses within 0.5°, final
    faces within 1%."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.models import (
        merge,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops.triangulate import (
        make_calibration,
    )
    from structured_light_for_3d_model_replication_tpu_torch.stream import (
        IncrementalSession,
        StreamParams,
    )

    h, w = stacks.shape[2:]
    sp = StreamParams(
        merge=merge.MergeParams(voxel_size=6.0, ransac_iterations=2048,
                                icp_iterations=20, fpfh_max_nn=32,
                                normals_k=12, max_points=2048,
                                posegraph_iterations=20, step_deg=10.0,
                                final_max_points=4096),
        view_cap=8192, model_cap=32_768, window=3, final_depth=8,
        tsdf_grid_depth=6, tsdf_max_bricks=1024)
    out = {}
    for d in (dev, torch.device("cpu")):
        calib = make_calibration(*rig, h, w, proj.width, proj.height,
                                 device=d)
        sess = IncrementalSession(calib, proj.col_bits, proj.row_bits,
                                  params=sp, device=d)
        for k in range(stacks.shape[0]):
            sess.add_stop(stacks[k])
        out[d.type] = (sess.stops_fused, sess.finalize(mesh=True))
    (nf_d, f_d), (nf_c, f_c) = out[dev.type], out["cpu"]
    gap = max(rotation_deg(f_d.poses[i][:3, :3] @ f_c.poses[i][:3, :3].T)
              for i in range(len(f_c.poses)))
    a, b = len(f_d.mesh.faces), len(f_c.mesh.faces)
    print(f"small rig TSDF session, {dev.type} vs cpu: {nf_d} vs {nf_c} "
          f"fused stops, worst pose gap {gap:.4f} deg, final mesh {a} vs {b}"
          f" faces", flush=True)
    if nf_d != nf_c or gap > 0.5 or abs(a - b) > 0.01 * b:
        fail(f"the TSDF session on {dev.type} disagrees with the host run")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and check the kernels only (no main path, "
                         "no result line)")
    ap.add_argument("--profile", action="store_true",
                    help="after the checked run, profile one more main-path "
                         "run and print where the device time goes")
    ap.add_argument("--diagnose-determinism", action="store_true",
                    help="build, then run the 360° and mesh paths once "
                         "under torch.use_deterministic_algorithms(True, "
                         "warn_only=True) and print what it names (no "
                         "checks, no result line)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}",
          flush=True)
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn "
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    from structured_light_for_3d_model_replication_tpu_torch.kernels import (
        build,
    )

    t0 = time.perf_counter()
    build.library()
    print(f"kernels ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {build.build_seconds if build.build_seconds is not None else 'cached'} s)",
          flush=True)
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    if args.diagnose_determinism:
        diagnose_determinism(dev)
        return 0
    band = sphere_band(dev)
    kernels = [check_decode(dev), check_nearest_one(dev),
               check_matvec(dev, band), check_classify(dev, band),
               check_combine(dev), check_brick_knn(dev),
               check_composite(dev)]
    del band
    if args.kernels_only:
        return 0
    launches, ring, ops = main_path(dev, N_STOPS, profile=args.profile)
    path_kernel_timings(ops)
    del ops
    launches["tsdf_combine"] = stream_path(dev, ring)["tsdf_combine"]
    launches["composite_cells"], on_path = splat_path(dev, ring)
    composite = kernels[-1]
    on_path["max_abs_err"] = max(on_path["max_abs_err"],
                                 composite["max_abs_err"])
    composite.update(on_path)
    del ring
    launches["brick_knn_cells"] = cleanup_path(dev)
    small_rig_agreement(dev)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in order}
                                  for k in kernels]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
